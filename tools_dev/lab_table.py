"""On-chip kernel-lab comparison table.

Runs every kernel-lab variant (graphtap/tools/kernel_lab.py) on the
chip over the same RMAT graph and writes one artifact with
time / GTEPS / streamed slots / checksum — the reference's singlenode
format comparison (src/singlenode/main.slurm:31-40, csc_spmv.hpp:222-228
op-count + checksum cross-equality), finally with numbers.

Resumable: rows land in LAB_RMAT<scale>.jsonl one per line; re-running
skips recorded variants.  Render with ``--render`` to (re)write
docs/LAB_RMAT<scale>.md from the jsonl.

Usage: python tools_dev/lab_table.py [--scale 18] [--iters 20] [--render]
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CACHE = os.path.join(ROOT, ".bench_cache")


def render(scale, rows):
    rows = sorted(rows, key=lambda r: r["which"])
    base = next((r for r in rows if r["which"] == 0), None)
    lines = [
        f"# Kernel lab on-chip comparison — RMAT-{scale}",
        "",
        "One chip; PageRank, identical graph/iterations per variant "
        "(the reference's singlenode format suite, "
        "`src/singlenode/main.slurm:31-40`).  `operations` is computed "
        "from each variant's OWN tileset, so the cross-variant equality "
        "below is a real format invariant (`csc_spmv.hpp:222-228`); "
        "`slots` is the padded work the variant actually streams.",
        "",
        "| # | variant | seconds | GTEPS | slots streamed | pad | "
        "checksum |",
        "|---|---------|---------|-------|----------------|-----|"
        "----------|",
    ]
    for r in rows:
        lines.append(
            f"| {r['which']} | {r['variant']} | {r['seconds']:.3f} | "
            f"{r['gteps']:.4f} | {r['slots']:,} | "
            f"x{r['pad_factor']:.2f} | {r['checksum']:.6g} |")
    if base:
        ops = {r["operations"] for r in rows}
        cs = {round(r["checksum"], 2) for r in rows}
        lines += [
            "",
            f"Cross-checks: operations {'EQUAL' if len(ops) == 1 else ops} "
            f"({base['operations']:,}); checksums "
            f"{'EQUAL' if len(cs) == 1 else 'within f32 tolerance'} "
            f"across all {len(rows)} variants.",
        ]
    out = os.path.join(ROOT, "docs", f"LAB_RMAT{scale}.md")
    with open(out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {out}")


def main():
    argv = sys.argv[1:]
    scale = int(argv[argv.index("--scale") + 1]) if "--scale" in argv else 18
    iters = int(argv[argv.index("--iters") + 1]) if "--iters" in argv else 20
    outp = os.path.join(ROOT, f"LAB_RMAT{scale}.jsonl")
    rows = []
    if os.path.exists(outp):
        rows = [json.loads(ln) for ln in open(outp) if ln.strip()]
    if "--render" in argv:
        render(scale, rows)
        return
    from graphtap.tools.compile_cache import setup_compile_cache
    setup_compile_cache()
    from graphtap.tools.artifact_cache import cached_rmat
    from graphtap.tools.kernel_lab import VARIANTS, run_variant
    cached_rmat(scale, 16, 1, CACHE)       # materialize the .bin
    path = os.path.join(CACHE, f"rmat{scale}_ef16_s1.bin")
    nv = (1 << scale) + 1
    done = {r["which"] for r in rows}
    with open(outp, "a") as fh:
        for which in sorted(VARIANTS):
            if which in done:
                print(f"[lab] variant {which}: recorded, skipping",
                      file=sys.stderr)
                continue
            t0 = time.perf_counter()
            r = run_variant(which, path, nv, iters)
            r["which"] = which
            r["total_seconds"] = round(time.perf_counter() - t0, 1)
            fh.write(json.dumps(r) + "\n")
            fh.flush()
            rows.append(r)
            print(f"[lab] {which} {r['variant']}: {r['gteps']:.4f} GTEPS "
                  f"cs={r['checksum']:.6g} (+{r['total_seconds']}s)",
                  file=sys.stderr)
    # cross-equality gates (op counts exact; checksum to f32 tolerance)
    ops = {r["operations"] for r in rows}
    assert len(ops) == 1, f"op-count mismatch across variants: {ops}"
    cs = [r["checksum"] for r in rows]
    assert max(cs) - min(cs) <= 1e-5 * max(abs(c) for c in cs), cs
    render(scale, rows)


if __name__ == "__main__":
    main()
