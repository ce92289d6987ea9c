"""Edge-list converter: text↔binary, weighted↔unweighted, id displacement.

Parity with the reference's ``bin/converter`` (src/misc/converter.cpp):
converts between text and binary edge lists, optionally adds random
weights in [1, 128] (converter.cpp:81,130) or strips them, applies a
vertex-id displacement offset, and prints vertex/edge counts.

Usage:
  python -m graphtap.tools.converter <in> <out>
      [--weights {keep,add,strip}] [--displacement N] [--seed N]
      [--in-weighted] [--text-out]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from graphtap.ingest.io import read_edge_list, write_binary


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--in-weighted", action="store_true")
    p.add_argument("--weights", choices=["keep", "add", "strip"],
                   default="keep")
    p.add_argument("--displacement", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--text-out", action="store_true")
    args = p.parse_args(argv)

    r, c, w = read_edge_list(args.input, has_weight=args.in_weighted)
    r = r + args.displacement
    c = c + args.displacement
    if args.weights == "add" and w is None:
        rng = np.random.default_rng(args.seed)
        # reference: 1 + rand() % 128 (converter.cpp:81)
        w = rng.integers(1, 129, size=r.size).astype(np.int32)
    elif args.weights == "strip":
        w = None

    if args.text_out:
        with open(args.output, "w") as f:
            if w is None:
                for a, b in zip(r, c):
                    f.write(f"{a} {b}\n")
            else:
                for a, b, ww in zip(r, c, w):
                    f.write(f"{a} {b} {ww}\n")
    else:
        write_binary(args.output, r, c, w)

    nv = int(max(r.max(initial=0), c.max(initial=0))) + 1 if r.size else 0
    print(f"Vertices: {nv}")
    print(f"Edges: {r.size}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
