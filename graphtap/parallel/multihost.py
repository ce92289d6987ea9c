"""Multi-host runtime: process init, distributed ingest, global arrays.

The reference scales across nodes with `mpirun` + MPI_COMM_WORLD
(reference: src/mpi/env.hpp:77-93); its ingest does a pairwise-Sendrecv
all-to-all so every rank ends with exactly its tiles' edges
(Matrix::distribute, matrix.hpp:692-810), and its filtering ORs partial
nnz bitvectors up to group leaders (matrix.hpp:861-1122). The JAX
equivalents here:

  initialize()          jax.distributed.initialize + (process_index, count)
  host_edge_share()     routing by *selection*: the mask of edges owned by
                        this process's devices (replaces the all-to-all
                        destination computation)
  exchange_edges()      byte-range shares → per-host full edge sets for
                        their own devices. Implemented as a host-side
                        allgather + select (one-time ingest cost; the
                        reference's alltoallv is a bandwidth optimization
                        of the same exchange)
  global_or() / global_max() / global_sum()
                        the filtering/count reductions (replaces the
                        leader OR-combine choreography) via
                        multihost_utils.process_allgather
  put_device_stacked()  build a global (D, ...) jax.Array from the rows
                        this process can address — single-process
                        device_put degenerates to the same layout
  allgather_state()     full global value of a device-stacked array on
                        every host (replaces checksum's MPI_Allreduce
                        gather, vertex_program.hpp:1927-1960)

Every host must call these collectively (they are barriers), mirroring
the reference's SPMD discipline.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graphtap.parallel.layout import Partition, ROWS, COLS


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> Tuple[int, int]:
    """Initialize the multi-host runtime (no-op on a single host).

    The analog of Env::init (env.hpp:77-93); barriers come from
    collective ops rather than MPI_Barrier."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
    return jax.process_index(), jax.process_count()


def proc_of_devices(mesh: Mesh) -> np.ndarray:
    """process index of each mesh device, flat row-major order."""
    return np.array([d.process_index for d in mesh.devices.reshape(-1)])


def host_edge_share(r: np.ndarray, c: np.ndarray, part: Partition,
                    mesh: Mesh, process_index: Optional[int] = None,
                    proc_map: Optional[np.ndarray] = None) -> np.ndarray:
    """Boolean mask of edges whose tile lives on this process's devices
    (the destination routing of Matrix::distribute, matrix.hpp:692-810,
    done by selection). ``process_index``/``proc_map`` are injectable for
    single-process simulation tests."""
    if process_index is None:
        process_index = jax.process_index()
    if proc_map is None:
        proc_map = proc_of_devices(mesh)
    dev = part.edge_device(r, c)
    return proc_map[dev] == process_index


def _allgather_host(x: np.ndarray) -> np.ndarray:
    """(P, ...) stack of every process's copy of x (identity stack for
    P=1)."""
    if jax.process_count() == 1:
        return np.asarray(x)[None]
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(jax.numpy.asarray(x)))


def global_or(mask: np.ndarray) -> np.ndarray:
    """OR-reduce a boolean array across processes (the leader bitvector
    OR-combine, matrix.hpp:990-1006)."""
    if jax.process_count() == 1:
        return mask
    g = _allgather_host(mask.astype(np.uint8))
    return g.any(axis=0)


def global_max(x) -> np.ndarray:
    if jax.process_count() == 1:
        return np.asarray(x)
    return _allgather_host(np.asarray(x)).max(axis=0)


def global_sum(x) -> np.ndarray:
    if jax.process_count() == 1:
        return np.asarray(x)
    return _allgather_host(np.asarray(x)).sum(axis=0)


EXCHANGE_CHUNK = 1 << 22   # edges per allgather round (bounds peak memory)


def exchange_edges(r: np.ndarray, c: np.ndarray, w: Optional[np.ndarray],
                   part: Partition, mesh: Mesh):
    """From per-host byte-range shares to per-host ownership: gather every
    host's share and keep the edges of this host's devices. One-time
    ingest cost (reference: the triple all-to-all, matrix.hpp:692-810).
    Also checks the edge-count conservation invariant (graph.hpp:299-300).

    The gather runs in bounded EXCHANGE_CHUNK rounds so peak memory is
    O(P * chunk), not O(total edges) — the memory discipline of the
    reference's pairwise alltoallv without its pairwise choreography."""
    if jax.process_count() == 1:
        return r, c, w
    n_local = np.int64(r.size)
    counts = _allgather_host(n_local)
    cap = int(counts.max())
    total = int(counts.sum())

    keep_r, keep_c, keep_w = [], [], []
    n_seen = 0
    for lo in range(0, cap, EXCHANGE_CHUNK):
        hi = min(cap, lo + EXCHANGE_CHUNK)
        width = hi - lo

        def pad(a, dtype):
            out = np.zeros(width, dtype=dtype)
            seg = a[lo:hi]
            out[:seg.size] = seg
            return out

        gr = _allgather_host(pad(r.astype(np.int64), np.int64))
        gc = _allgather_host(pad(c.astype(np.int64), np.int64))
        gw = _allgather_host(pad(w, w.dtype)) if w is not None else None
        keepv = np.concatenate(
            [np.arange(lo, hi) < counts[p] for p in range(counts.size)])
        rr = gr.reshape(-1)[keepv]
        cc = gc.reshape(-1)[keepv]
        n_seen += rr.size
        mine = host_edge_share(rr, cc, part, mesh)
        keep_r.append(rr[mine])
        keep_c.append(cc[mine])
        if gw is not None:
            keep_w.append(gw.reshape(-1)[keepv][mine])
    assert n_seen == total, "edge count not conserved across the exchange"
    rr = np.concatenate(keep_r) if keep_r else r[:0]
    cc = np.concatenate(keep_c) if keep_c else c[:0]
    ww = (np.concatenate(keep_w) if keep_w else w[:0]) \
        if w is not None else None
    return rr, cc, ww


def put_device_stacked(a: np.ndarray, mesh: Mesh):
    """Place a host-built (D, ...) array with the leading axis sharded
    over the flat mesh. Multi-process: assemble the global array from the
    rows of this process's addressable devices (rows for other processes'
    devices may be garbage — every process contributes its own)."""
    spec = P((ROWS, COLS), *([None] * (a.ndim - 1)))
    sharding = NamedSharding(mesh, spec)
    if jax.process_count() == 1:
        return jax.device_put(a, sharding)
    flat = mesh.devices.reshape(-1)
    pidx = jax.process_index()
    shards = [jax.device_put(a[i:i + 1], d)
              for i, d in enumerate(flat) if d.process_index == pidx]
    return jax.make_array_from_single_device_arrays(a.shape, sharding,
                                                    shards)


def allgather_state(v) -> np.ndarray:
    """Full global value of a device-stacked array on every host
    (replaces the master-side gather of checksum1,
    vertex_program.hpp:1963-2119)."""
    if jax.process_count() == 1:
        return np.asarray(v)
    from jax.experimental import multihost_utils
    return np.asarray(multihost_utils.process_allgather(v, tiled=True))
