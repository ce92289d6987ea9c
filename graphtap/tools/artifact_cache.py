"""On-disk cache for expensive host-side build artifacts.

The reference never rebuilds its inputs per run — the SLURM benchmarks
consume pre-built RMAT binaries (reference: graphtap.slurm:43-48). Here
the RMAT edge lists and tile builds are pure functions of (generator
seed, partition, compression), so they are built once and memoized to
disk; ``bench.py`` and ``chip_smoke.py`` use this to keep repeated runs
free of host-side generation cost.

Everything is numpy ``.npz`` (uncompressed — load speed matters more
than bytes here) plus a JSON meta entry for scalar fields.
"""

from __future__ import annotations

import json
import os

import numpy as np

from graphtap.config import Compression
from graphtap.format.tiles import TileSet
from graphtap.parallel.layout import Partition

_META = "__meta__"


def _pack_meta(d: dict) -> np.ndarray:
    return np.frombuffer(json.dumps(d).encode(), dtype=np.uint8)


def _unpack_meta(a: np.ndarray) -> dict:
    return json.loads(bytes(a).decode())


# ----------------------------------------------------------------- TileSet
_TS_ARRAYS = ("rows", "cols", "weights", "nnz", "ja", "ir", "iv_dense",
              "nnzrows", "i_own", "j_own", "regular_own", "source_own",
              "sink_own", "nnzcols", "jc")


def save_tileset(ts: TileSet, path: str) -> None:
    arrays = {}
    for k in _TS_ARRAYS:
        v = getattr(ts, k)
        if v is not None:
            arrays[k] = v
    meta = {
        "compression": ts.compression.value,
        "has_weight": ts.has_weight,
        "Ep": ts.Ep, "NR": ts.NR, "nnz_total": ts.nnz_total,
        "part": [ts.part.nv, ts.part.R, ts.part.C, ts.part.L],
    }
    arrays[_META] = _pack_meta(meta)
    np.savez(path, **arrays)


def load_tileset(path: str) -> TileSet:
    with np.load(path) as z:
        meta = _unpack_meta(z[_META])
        arrays = {k: (z[k] if k in z.files else None) for k in _TS_ARRAYS}
    nv, R, C, L = meta["part"]
    part = Partition(nv=nv, R=R, C=C, L=L)
    return TileSet(part=part, compression=Compression(meta["compression"]),
                   has_weight=meta["has_weight"], Ep=meta["Ep"],
                   NR=meta["NR"], nnz_total=meta["nnz_total"], **arrays)


# ------------------------------------------------------------- edge lists
def cached_rmat(scale: int, edge_factor: int, seed: int,
                cache_dir: str, weighted: bool = False):
    """RMAT edges memoized as a raw binary edge list (the same
    ``(u32,u32[,u32])`` stream the reference's data files use)."""
    from graphtap.ingest.io import read_edge_list, write_binary
    from graphtap.ingest.rmat import rmat_edges
    os.makedirs(cache_dir, exist_ok=True)
    tag = "w" if weighted else ""
    path = os.path.join(cache_dir,
                        f"rmat{scale}_ef{edge_factor}_s{seed}{tag}.bin")
    if os.path.exists(path):
        r, c, w = read_edge_list(path, has_weight=weighted)
        return r, c, w
    r, c, w = rmat_edges(scale=scale, edge_factor=edge_factor, seed=seed,
                         weighted=weighted)
    write_binary(path + ".tmp", r, c, w)
    os.replace(path + ".tmp", path)
    return r, c, w
