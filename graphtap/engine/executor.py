"""Executor: the jitted superstep loop under shard_map.

Re-creates ``Vertex_Program::execute`` (reference: vertex_program.hpp:407-441)
— the BSP loop ``scatter_gather → combine → apply → converged?`` — as one
XLA program: a ``lax.fori_loop`` (fixed iterations) or ``lax.while_loop``
(convergence mode) whose body is a single fused superstep running under
``jax.shard_map`` on the ('rows','cols') mesh.

Phase mapping (reference → here):
  scatter_gather (x build + bcast/scatter, :639-1013)
      → messenger on the owner segment, inactive slots masked to the
        ⊕-identity (the reference's infinity(), :728), then
        ``lax.all_gather(axis='rows')``.
  combine (tile SpMV sweep + partial-y sends, :1017-1506)
      → gather/⊗/segment-⊕ kernel (kernels/spmv.py) into the renumbered
        row space, scatter to the dense row block, then
        ``lax.psum_scatter(axis='cols')`` (sum semirings) or
        all_to_all + ⊕-fold (min/max semirings).
  combine_postprocess (leader-side ⊕-fold of partial y, :1510-1573)
      → free: the reduce-scatter is the fold.
  apply (:1610-1802)
      → vectorized applicator masked to the I rows (TCSC semantics,
        :1655-1670).
  has_converged (:1885-1923)
      → psum of the per-device all(~C) vote over both mesh axes.
  the post-convergence flush (one extra combine+apply with the stale x,
  :425-429) → run unconditionally after the while_loop from the carried
  stale messages.

The nonstationary mode (BFS/SSSP/CC) uses dense masked message vectors
(x[j] = infinity for inactive j), which is the reference's own dense
nonstationary path (:711-758); the activity-compressed exchange
(:865-966, triggered at ≤0.6 active fraction) is the optional sparse
exchange behind ``EngineConfig.sparse_exchange_capacity``.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graphtap.config import Compression, EngineConfig, Ordering
from graphtap.engine.program import VertexProgram, State
from graphtap.format.tiles import TileSet
from graphtap.ingest.graph import Graph
from graphtap.kernels.spmv import (spmv_segment, spmv_sorted_scan,
                                   expand_compact)
from graphtap.parallel.layout import Partition, ROWS, COLS

_MAX_CONVERGENCE_ITERS = 1 << 20

# The two SpMV implementations of kernels/spmv.py; both are plain XLA.
# 'scan' is the default for every semiring: on an H100 it was as fast as
# 'segment' for PageRank (plus-times) and faster for BFS (min); PERF.md.
KERNELS = ("scan", "segment")
DEFAULT_KERNEL = "scan"


def _spec(ndim_extra: int) -> P:
    return P((ROWS, COLS), *([None] * ndim_extra))


class Executor:
    """Runs one VertexProgram over one TileSet on the mesh."""

    def __init__(self, graph: Graph, program: VertexProgram,
                 engine: Optional[EngineConfig] = None,
                 tiles: Optional[TileSet] = None,
                 kernel: Optional[str] = None):
        self.graph = graph
        self.program = program
        self.engine = engine or EngineConfig(stationary=program.stationary)
        # 'scan'    — segmented associative scan + row-pointer gather;
        # 'segment' — jax.ops.segment_{sum,min,max} over sorted rows.
        # None picks DEFAULT_KERNEL.
        if kernel is None:
            kernel = DEFAULT_KERNEL
        if kernel not in KERNELS:
            raise ValueError(
                f"unknown SpMV kernel {kernel!r}; choose one of {KERNELS}")
        self.kernel = kernel
        self.part: Partition = graph.part
        self.mesh: Mesh = graph.mesh
        self.tiles = tiles if tiles is not None else graph.tiled(self.engine.ordering)
        self._dev_tiles = self.tiles.device_arrays(self.mesh)
        self._vids = self._put(self.part.owner_vids())      # (D, L) int32
        self.state: Optional[State] = None
        self.changed: Optional[jnp.ndarray] = None
        self.iteration: int = 0
        self._renumber = self.tiles.ir is not None
        self._apply_i_mask = self.tiles.compression in (
            Compression.TCSC, Compression.TCSC_CF)
        self._phase_tiles = {"main": self.tiles}

    # ------------------------------------------------------------------ util
    def _put(self, arr: np.ndarray):
        return jax.device_put(
            arr, NamedSharding(self.mesh, _spec(arr.ndim - 1)))

    def sync_uploads(self) -> None:
        """Block until the constructor's async tile device_puts land
        on-device — lets callers attribute upload vs compile time
        (device_put is otherwise fully asynchronous)."""
        jax.block_until_ready(self._dev_tiles)

    # ------------------------------------------------------------- lifecycle
    def initialize(self, other: Optional["Executor"] = None) -> None:
        """Build initial state (reference: initialize(), :444-503; the
        cross-program handoff variant takes the predecessor's state,
        :467-483)."""
        vids = self.part.owner_vids()
        i_mask = self.tiles.i_own
        other_state = None
        if other is not None:
            # multi-process: the predecessor's state is device-stacked and
            # only partially addressable here — gather the global value
            # (no-op single-process)
            from graphtap.parallel.multihost import allgather_state
            other_state = {k: allgather_state(v)
                           for k, v in other.state.items()}
        state_np, changed_np = self.program.init(vids, i_mask, other_state)
        self.state = {k: self._put(np.asarray(v)) for k, v in state_np.items()}
        valid = vids < self.graph.nv
        self.changed = self._put(np.asarray(changed_np, dtype=bool) & valid)
        self.iteration = 0

    # ------------------------------------------------------------- superstep
    def _combine(self, x, tile, phase="main"):
        """Tile SpMV + partial-y reduction → the owner's y segment (L,).

        (reference: combine + combine_postprocess,
        vertex_program.hpp:1017-1573)."""
        sem = self.program.semiring
        w = tile["weights"][0] if tile["weights"] is not None else None
        if "jc" in tile:
            # DCSC: cols hold compact nnz-col ids — gather x through the
            # JC table first (reference: the x[JC[j]] reads of the DCSC
            # kernel, dcsc_spmv.hpp:216-230 / vertex_program.hpp:1186-1216)
            x = jnp.take(x, tile["jc"][0], axis=0)
        if self.kernel == "scan":
            y_comp = spmv_sorted_scan(
                x, tile["rows"][0], tile["cols"][0], w, tile["nnz"][0, 0],
                tile["ja"][0], sem)                              # (NR,)
        else:
            y_comp = spmv_segment(
                x, tile["rows"][0], tile["cols"][0], w, tile["nnz"][0, 0],
                self._phase_tiles[phase].NR, sem)                # (NR,)
        if self._renumber:
            y_dense = expand_compact(y_comp, tile["iv_dense"][0], sem)
        else:
            y_dense = y_comp                                     # (C*L,)
        return self._exchange_y(y_dense)                         # (L,)

    def _apply(self, Vl, y_own, tile, it):
        """(reference: apply_*, vertex_program.hpp:1610-1802). TCSC
        applies only where the I bit is set (:1655-1670); TCSC_CF phases
        carry an explicit apply mask (regular rows each iteration, source
        rows only on the last — :1671-1692)."""
        prog = self.program
        V2l, changed = prog.applicator(Vl, y_own, it)
        mask = tile["apply_mask"][0] if "apply_mask" in tile else (
            tile["i_own"][0] if self._apply_i_mask else None)
        if mask is not None:
            V2l = {k: jnp.where(mask, v2, Vl[k]) for k, v2 in V2l.items()}
            changed = changed & mask
        changed = changed & (tile["vids"][0] < self.graph.nv)
        return V2l, changed

    def _exchange_y(self, y_dense):
        """Partial-y reduction along the cols axis (reference: the
        follower→leader partial-y sends + leader-side ⊕-fold,
        vertex_program.hpp:1083-1111, 1510-1573). Sum semirings
        reduce-scatter (the fold IS the collective); min/max use
        all_to_all + ⊕-fold. With ``sparse_exchange_capacity = K`` and a
        nonstationary program, the sparse YI/YV protocol (reference
        :912-966, 1543-1573): if every sender's per-segment active count
        fits in K, exchange compacted (index, value) pairs and
        scatter-⊕ on the receiver, with the same psum'd fits-vote as the
        x side so every cols-group device takes the same branch."""
        sem, part = self.program.semiring, self.part
        L, Cc = part.L, part.C
        if sem.reduce_kind == "sum":
            return lax.psum_scatter(y_dense, COLS,
                                    scatter_dimension=0, tiled=True)
        y2 = y_dense.reshape(Cc, L)
        K = self.engine.sparse_exchange_capacity
        if not K or self.program.stationary:
            parts = lax.all_to_all(y2, COLS, split_axis=0, concat_axis=0)
            return sem.axis_reduce(parts, axis=0)
        K = min(K, L)
        ident = sem.identity_like(y_dense.dtype)
        act = y2 != ident
        nact = jnp.sum(act.astype(jnp.int32), axis=1)       # per segment
        fits = lax.psum((jnp.max(nact) <= K).astype(jnp.int32), COLS) == Cc

        def sparse(_):
            order = jnp.argsort(~act, axis=1, stable=True)  # active first
            idx = order[:, :K].astype(jnp.int32)            # (Cc, K)
            val = jnp.take_along_axis(y2, idx, axis=1)
            ok = lax.broadcasted_iota(jnp.int32, (Cc, K), 1) < nact[:, None]
            idx = jnp.where(ok, idx, jnp.int32(L))          # park slot
            gi = lax.all_to_all(idx, COLS, split_axis=0, concat_axis=0)
            gv = lax.all_to_all(val, COLS, split_axis=0, concat_axis=0)
            y = jnp.full((L + 1,), ident, y_dense.dtype)
            if sem.reduce_kind == "min":
                y = y.at[gi.reshape(-1)].min(gv.reshape(-1), mode="drop")
            else:
                y = y.at[gi.reshape(-1)].max(gv.reshape(-1), mode="drop")
            return y[:L]

        def dense(_):
            parts = lax.all_to_all(y2, COLS, split_axis=0, concat_axis=0)
            return sem.axis_reduce(parts, axis=0)

        return lax.cond(fits, sparse, dense, None)

    def _exchange_x(self, m, c):
        """Message exchange along the rows axis (reference: scatter/bcast,
        vertex_program.hpp:788-1013).

        Dense by default (one tiled all_gather). With
        ``sparse_exchange_capacity = K`` and a nonstationary program, the
        activity-filtered protocol (reference :865-966): if every
        column-group sender's active count fits in K, exchange the
        compacted (index, value) pairs and rebuild x on the receiver;
        otherwise fall back to the dense gather — the per-iteration
        sparse/dense vote the reference takes at activity ratio ≤ 0.6
        (:767, :1378), here a psum'd fits-vote so all mesh devices take
        the same lax.cond branch."""
        K = self.engine.sparse_exchange_capacity
        if not K or self.program.stationary:
            return lax.all_gather(m, ROWS, tiled=True)
        sem, part = self.program.semiring, self.part
        L, R = part.L, part.R
        K = min(K, L)
        nact = jnp.sum(c.astype(jnp.int32))
        fits = lax.psum((nact <= K).astype(jnp.int32), ROWS) == R

        def sparse(_):
            order = jnp.argsort(~c, stable=True)        # active slots first
            idx = order[:K].astype(jnp.int32)
            val = jnp.take(m, idx, axis=0)
            ok = lax.broadcasted_iota(jnp.int32, (K, 1), 0)[:, 0] < nact
            idx = jnp.where(ok, idx, jnp.int32(R * L))
            gidx = lax.all_gather(idx, ROWS)             # (R, K)
            gval = lax.all_gather(val, ROWS)
            off = lax.broadcasted_iota(jnp.int32, (R, 1), 0) * L
            gi = jnp.where(gidx < L, gidx + off, jnp.int32(R * L))
            x = jnp.full((R * L,), sem.identity_like(m.dtype), m.dtype)
            return x.at[gi.reshape(-1)].set(gval.reshape(-1), mode="drop")

        def dense(_):
            return lax.all_gather(m, ROWS, tiled=True)

        return lax.cond(fits, sparse, dense, None)

    def _local_superstep(self, V: State, C, tile, it, phase="main"):
        """One BSP superstep; everything is device-local under shard_map.

        V leaves: (1, L); C: (1, L); tile leaves: (1, ...). Returns
        (V', C', m, votes)."""
        prog, sem = self.program, self.program.semiring

        # --- scatter_gather: x build (reference :688-758)
        Vl = {k: v[0] for k, v in V.items()}
        m = prog.messenger(Vl).astype(prog.value_dtype)         # (L,)
        if not prog.stationary:
            m = jnp.where(C[0], m, sem.identity_like(m.dtype))
        x = self._exchange_x(m, C[0])                            # (R*L,)

        y_own = self._combine(x, tile, phase)
        V2l, changed = self._apply(Vl, y_own, tile, it)

        # --- convergence vote (reference :1885-1923)
        votes = lax.psum(jnp.all(~changed).astype(jnp.int32), (ROWS, COLS))

        V2 = {k: v[None] for k, v in V2l.items()}
        return V2, changed[None], m, votes

    def _local_flush(self, V: State, C, tile, m_stale, it, phase="main"):
        """Post-convergence combine+apply with the stale x
        (reference :425-429)."""
        x = lax.all_gather(m_stale, ROWS, tiled=True)
        y_own = self._combine(x, tile, phase)
        Vl = {k: v[0] for k, v in V.items()}
        V2l, changed = self._apply(Vl, y_own, tile, it)
        return {k: v[None] for k, v in V2l.items()}, changed[None]

    # --------------------------------------------------------------- TIMING
    @functools.cached_property
    def _profiled_sg(self):
        mesh, spec1 = self.mesh, _spec(1)
        prog, sem = self.program, self.program.semiring

        def sg(V, C):
            Vl = {k: v[0] for k, v in V.items()}
            m = prog.messenger(Vl).astype(prog.value_dtype)
            if not prog.stationary:
                m = jnp.where(C[0], m, sem.identity_like(m.dtype))
            return self._exchange_x(m, C[0])[None]

        return jax.jit(jax.shard_map(
            sg, mesh=mesh, in_specs=(spec1, spec1), out_specs=spec1,
            check_vma=False))

    @functools.lru_cache(maxsize=None)
    def _profiled_phase_jits(self, phase: str):
        """combine/apply jits for one tile phase ('main', or the TCSC_CF
        'first'/'middle'/'last' plans — the fused loop's _cf_pytrees,
        reference: spmv_stationary phase gating vertex_program.hpp:
        1243-1320).  Per-phase because the kernel meta baked into the
        closure is phase-static."""
        mesh, spec1 = self.mesh, _spec(1)
        tree = self._tile_pytree if phase == "main" else \
            self._cf_pytrees[phase]
        tspec = jax.tree.map(lambda _: spec1, dict(tree))

        def combine(x, tile):
            tile = self._tile_with_w(tile)
            return self._combine(x[0], tile, phase)[None]

        def apply_(V, C, y, tile, it):
            Vl = {k: v[0] for k, v in V.items()}
            V2l, changed = self._apply(Vl, y[0], tile, it)
            votes = lax.psum(jnp.all(~changed).astype(jnp.int32),
                             (ROWS, COLS))
            return ({k: v[None] for k, v in V2l.items()}, changed[None],
                    votes)

        return {
            "tree": tree,
            "combine": jax.jit(jax.shard_map(
                combine, mesh=mesh, in_specs=(spec1, tspec),
                out_specs=spec1, check_vma=False)),
            "apply": jax.jit(jax.shard_map(
                apply_, mesh=mesh,
                in_specs=(spec1, spec1, spec1, tspec, P()),
                out_specs=(spec1, spec1, P()), check_vma=False)),
        }

    def execute_profiled(self, num_iterations: int, timer=None,
                         printer=print) -> "PhaseTimer":
        """Run with per-phase wall-clock timing and per-iteration progress
        (the reference's -DTIMING mode + ``Iteration: n`` lines,
        vertex_program.hpp:422, :2134-2152). Returns the PhaseTimer.

        Result-identical to execute(): TCSC_CF runs the first/middle/last
        phase plans in the same positions as the fused loops, and
        convergence mode ends with the post-convergence flush — one extra
        combine+apply from the stale x (reference :425-429), using the
        'last' CF phase where the fused _run_converge_cf does."""
        from graphtap.tools.timing import PhaseTimer
        if self.state is None:
            self.initialize()
        timer = timer or PhaseTimer()
        sg = self._profiled_sg
        is_cf = self.tiles.compression == Compression.TCSC_CF
        V, C = self.state, self.changed
        # num_iterations <= 0 = run to convergence (the reference's default
        # execute(0) mode, vertex_program.hpp:412-413)
        converge = not (num_iterations and num_iterations > 0)
        max_it = _MAX_CONVERGENCE_ITERS if converge else num_iterations
        it = -1
        x = None
        converged = False
        use_cf = is_cf and (converge or max_it > 1)   # execute() parity:
        # a 1-iteration CF run uses the main tiles (executor.execute)
        if use_cf:
            self._cf_pytrees          # materialize phase plans once
        for it in range(max_it):
            if not use_cf:
                phase = "main"
            elif it == 0:
                phase = "first"
            elif not converge and it == max_it - 1:
                phase = "last"
            else:
                phase = "middle"
            ph = self._profiled_phase_jits(phase)
            with timer.phase("scatter_gather"):
                x = sg(V, C)
                jax.block_until_ready(x)
            with timer.phase("combine"):
                y = ph["combine"](x, ph["tree"])
                jax.block_until_ready(y)
            with timer.phase("apply"):
                V, C, votes = ph["apply"](V, C, y, ph["tree"],
                                          jnp.int32(it))
                jax.block_until_ready(V)
            if printer is not None:
                printer(f"Iteration: {it + 1}")
            if converge and int(votes) == self.part.D:
                converged = True
                break
        if converge and converged and x is not None:
            # post-convergence flush with the stale x (reference :425-429):
            # x of the final iteration is exactly all_gather(m_stale)
            ph = self._profiled_phase_jits("last" if use_cf else "main")
            with timer.phase("combine"):
                y = ph["combine"](x, ph["tree"])
                jax.block_until_ready(y)
            with timer.phase("apply"):
                V, C, _v = ph["apply"](V, C, y, ph["tree"],
                                       jnp.int32(it + 1))
                jax.block_until_ready(V)
        self.state, self.changed = V, C
        self.iteration = it + 1
        if printer is not None:
            printer(timer.report())
        return timer

    # ---------------------------------------------------------------- loops
    @functools.cached_property
    def _tile_pytree(self):
        t = dict(self._dev_tiles)
        t["vids"] = self._vids
        # drop fields the superstep doesn't consume
        for k in ("nnzrows", "j_own", "regular_own", "source_own", "sink_own",
                  "ir"):
            t.pop(k, None)
        if t.get("iv_dense") is None:
            t.pop("iv_dense", None)
        if t.get("jc") is None:
            t.pop("jc", None)
        if t["weights"] is None:
            t.pop("weights")
            self._has_w = False
        else:
            self._has_w = True
        return t

    def _tile_with_w(self, t):
        if "weights" not in t:
            t = dict(t)
            t["weights"] = None
        return t

    # ------------------------------------------------- TCSC_CF phase plans
    @functools.cached_property
    def _cf_pytrees(self):
        """Phase pytrees for TCSC_CF execution (first/middle/last edge
        subsets + apply masks; reference: spmv_stationary phase gating,
        vertex_program.hpp:1243-1320, apply :1671-1692)."""
        cf = self.graph.tiled_cf(self.engine.ordering)
        full = cf["full"]
        regular = full.regular_own
        src = full.source_own
        masks = {"first": regular, "middle": regular,
                 "last": regular | src}
        out = {}
        for ph in ("first", "middle", "last"):
            ts = cf[ph]
            self._phase_tiles[ph] = ts
            dev = ts.device_arrays(self.mesh)
            t = {k: v for k, v in dev.items() if v is not None}
            for k in ("nnzrows", "j_own", "regular_own", "source_own",
                      "sink_own", "ir", "i_own"):
                t.pop(k, None)
            t["vids"] = self._vids
            t["apply_mask"] = self._put(masks[ph])
            out[ph] = t
        return out

    @functools.cached_property
    def _run_fixed_cf(self):
        mesh = self.mesh

        def run(V, C, t_first, t_mid, t_last, niters):
            t_first_ = self._tile_with_w(t_first)
            t_mid_ = self._tile_with_w(t_mid)
            t_last_ = self._tile_with_w(t_last)
            V, C, _m, _v = self._local_superstep(V, C, t_first_,
                                                 jnp.int32(0), "first")

            def body(it, carry):
                V, C = carry
                V2, C2, _m, _v = self._local_superstep(V, C, t_mid_, it,
                                                       "middle")
                return (V2, C2)

            V, C = lax.fori_loop(1, niters - 1, body, (V, C))
            V, C, _m, _v = self._local_superstep(V, C, t_last_,
                                                 niters - 1, "last")
            return V, C

        spec1 = _spec(1)
        trees = self._cf_pytrees
        shmapped = jax.shard_map(
            run, mesh=mesh,
            in_specs=(spec1, spec1,
                      jax.tree.map(lambda _: spec1, dict(trees["first"])),
                      jax.tree.map(lambda _: spec1, dict(trees["middle"])),
                      jax.tree.map(lambda _: spec1, dict(trees["last"])),
                      P()),
            out_specs=(spec1, spec1),
            check_vma=False,
        )
        return jax.jit(shmapped)

    @functools.cached_property
    def _run_fixed(self):
        mesh, part = self.mesh, self.part

        def run(V, C, tile, niters):
            tile = self._tile_with_w(tile)

            def body(it, carry):
                V, C = carry
                V2, C2, _m, _votes = self._local_superstep(V, C, tile, it)
                return (V2, C2)

            return lax.fori_loop(0, niters, body, (V, C))

        spec1 = _spec(1)
        shmapped = jax.shard_map(
            run, mesh=mesh,
            in_specs=(spec1, spec1, jax.tree.map(lambda _: spec1, dict(self._tile_pytree)), P()),
            out_specs=(spec1, spec1),
            check_vma=False,
        )
        return jax.jit(shmapped, static_argnums=())

    @functools.cached_property
    def _run_converge_cf(self):
        """TCSC_CF convergence mode (reference: execute() with
        num_iterations=0 on a CF matrix — first-phase step, middle-phase
        steps with the regular-rows-only convergence vote (the middle
        apply mask IS the regular set, vertex_program.hpp:1885-1923), and
        the post-convergence last-phase flush with the stale x
        (:425-429, :1671-1692)."""
        mesh, part = self.mesh, self.part
        D = part.D

        def run(V, C, t_first, t_mid, t_last):
            t_first_ = self._tile_with_w(t_first)
            t_mid_ = self._tile_with_w(t_mid)
            t_last_ = self._tile_with_w(t_last)
            V, C, m, votes = self._local_superstep(V, C, t_first_,
                                                   jnp.int32(0), "first")

            def cond(carry):
                _V, _C, _m, it, converged = carry
                return (~converged) & (it < _MAX_CONVERGENCE_ITERS)

            def body(carry):
                V, C, _m, it, _conv = carry
                V2, C2, m, votes = self._local_superstep(V, C, t_mid_, it,
                                                         "middle")
                return (V2, C2, m, it + 1, votes == D)

            V, C, m, it, _ = lax.while_loop(
                cond, body, (V, C, m, jnp.int32(1), votes == D))
            V, C = self._local_flush(V, C, t_last_, m, it, "last")
            return V, C, it

        spec1 = _spec(1)
        trees = self._cf_pytrees
        shmapped = jax.shard_map(
            run, mesh=mesh,
            in_specs=(spec1, spec1,
                      jax.tree.map(lambda _: spec1, dict(trees["first"])),
                      jax.tree.map(lambda _: spec1, dict(trees["middle"])),
                      jax.tree.map(lambda _: spec1, dict(trees["last"])),),
            out_specs=(spec1, spec1, P()),
            check_vma=False,
        )
        return jax.jit(shmapped)

    @functools.cached_property
    def _run_converge(self):
        mesh, part = self.mesh, self.part
        D = part.D

        def run(V, C, tile):
            tile = self._tile_with_w(tile)
            m0 = lax.pcast(jnp.zeros((part.L,), dtype=self.program.value_dtype),
                           (ROWS, COLS), to="varying")

            def cond(carry):
                _V, _C, _m, it, converged = carry
                return (~converged) & (it < _MAX_CONVERGENCE_ITERS)

            def body(carry):
                V, C, _m, it, _conv = carry
                V2, C2, m, votes = self._local_superstep(V, C, tile, it)
                return (V2, C2, m, it + 1, votes == D)

            V, C, m, it, _ = lax.while_loop(
                cond, body, (V, C, m0, jnp.int32(0), jnp.bool_(False)))
            # one extra combine+apply to flush source/sink contributions
            # (reference :425-429)
            V, C = self._local_flush(V, C, tile, m, it)
            return V, C, it

        spec1 = _spec(1)
        shmapped = jax.shard_map(
            run, mesh=mesh,
            in_specs=(spec1, spec1, jax.tree.map(lambda _: spec1, dict(self._tile_pytree))),
            out_specs=(spec1, spec1, P()),
            check_vma=False,
        )
        return jax.jit(shmapped)

    def free(self) -> None:
        """Release the device-resident tile arrays
        (reference: Vertex_Program::free(), vertex_program.hpp:47-54 —
        called between the degree and PR programs to keep both formats
        from coexisting in memory). The state pytree (V/C) survives so a
        successor program can still initialize(other=self); execute()
        after free() is an error."""
        self._dev_tiles = None
        self.__dict__.pop("_tile_pytree", None)
        self.__dict__.pop("_cf_pytrees", None)

    # ------------------------------------------------------------------ API
    def execute(self, num_iterations: Optional[int] = None) -> int:
        """Run the loop; returns the iteration count
        (reference: execute(), :407-441)."""
        if self.state is None:
            self.initialize()
        niters = self.engine.num_iterations if num_iterations is None \
            else num_iterations
        tile = self._tile_pytree
        is_cf = self.tiles.compression == Compression.TCSC_CF
        if is_cf and niters and niters > 1:
            trees = self._cf_pytrees
            V, C = self._run_fixed_cf(self.state, self.changed,
                                      trees["first"], trees["middle"],
                                      trees["last"], niters)
            self.state, self.changed = V, C
            self.iteration = niters
        elif is_cf and not niters:
            trees = self._cf_pytrees
            V, C, it = self._run_converge_cf(self.state, self.changed,
                                             trees["first"], trees["middle"],
                                             trees["last"])
            self.state, self.changed = V, C
            self.iteration = int(it)
        elif niters and niters > 0:
            V, C = self._run_fixed(self.state, self.changed, tile, niters)
            self.state, self.changed = V, C
            self.iteration = niters
        else:
            V, C, it = self._run_converge(self.state, self.changed, tile)
            self.state, self.changed = V, C
            self.iteration = int(it)
        jax.block_until_ready(self.state)
        return self.iteration

    # -------------------------------------------------------------- oracles
    def state_vector(self) -> Dict[str, np.ndarray]:
        """Full state in vertex-id order, truncated to nv. Multi-process
        safe: non-addressable shards are fetched with
        multihost_utils.process_allgather (reference analog: the master
        gather of checksum1, vertex_program.hpp:1963-2119)."""
        from graphtap.parallel.multihost import allgather_state
        out = {}
        for k, v in self.state.items():
            arr = allgather_state(v)
            out[k] = self.part.to_vertex_order(arr)[: self.graph.nv]
        return out

    def checksum(self) -> Tuple[float, int]:
        """(value checksum, reachable count)
        (reference: checksum(), :1927-1960)."""
        sv = self.state_vector()
        vals = np.asarray(self.program.get_state(sv))
        inf = self.program.infinity()
        mask = vals != inf
        total = vals[mask].astype(np.float64).sum()
        return float(total), int(mask.sum())

    def stats(self) -> Dict[str, float]:
        """Distribution statistics over reachable states
        (reference: checksum1(), vertex_program.hpp:1963-2119)."""
        from graphtap.tools.oracle import state_stats
        sv = self.state_vector()
        vals = np.asarray(self.program.get_state(sv))
        return state_stats(vals, self.program.infinity())

    def display(self, count: int = 31) -> str:
        """First ``count`` vertex states (reference: display(), :2124-2181)."""
        sv = self.state_vector()
        lines = []
        for vid in range(min(count, self.graph.nv)):
            row = {k: v[vid] for k, v in sv.items()}
            lines.append(f"vid={vid}: {self.program.format_state(row)}")
        return "\n".join(lines)
