"""Graph: host-side container tying ingest, partitioning, and tiling.

The analog of the reference's ``Graph`` + ``Matrix`` pair
(reference: graph.hpp:33-67, matrix.hpp): ``Graph.load`` reads and
transforms the edge list, then ``tiled()`` produces the device-resident
``TileSet`` for a given ordering. The _COL_ ordering of the reference
(vertex_program.hpp:279-325) — running the engine on the transpose of the
loaded matrix without re-loading the file — is re-created by building a
second TileSet with row/col roles swapped from the same in-memory edges.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from jax.sharding import Mesh

from graphtap.config import GraphConfig, Compression, Ordering
from graphtap.ingest.io import read_edge_list, apply_transforms
from graphtap.format.tiles import TileSet, build_tileset
from graphtap.parallel.layout import Partition, make_mesh


@dataclass
class Graph:
    config: GraphConfig
    part: Partition
    mesh: Mesh
    # transformed (stored-orientation) edges, host-side
    r: np.ndarray
    c: np.ndarray
    w: Optional[np.ndarray]

    @property
    def nv(self) -> int:
        """Logical matrix dimension: num_vertices + 1, for vertex id 0
        (reference: graph.hpp:84-85)."""
        return self.config.num_vertices + 1

    @property
    def nedges(self) -> int:
        return int(self.r.size)

    @classmethod
    def load(cls, path: str, config: GraphConfig,
             mesh: Optional[Mesh] = None) -> "Graph":
        """Load an edge list. In a multi-process run every process reads
        its 1/nprocs byte range (reference: parread_*, graph.hpp:234-240)
        and the shares are exchanged so each process ends with exactly its
        devices' edges (reference: Matrix::distribute all-to-all,
        matrix.hpp:692-810 → parallel/multihost.py::exchange_edges)."""
        import jax
        if mesh is None:
            mesh = make_mesh()
        pidx, pcnt = jax.process_index(), jax.process_count()
        r, c, w = read_edge_list(path, has_weight=config.has_weight,
                                 process_index=pidx, process_count=pcnt)
        return cls._from_raw(r, c, w, config, mesh, distributed=pcnt > 1)

    @classmethod
    def from_edges(cls, r, c, w, config: GraphConfig,
                   mesh: Optional[Mesh] = None) -> "Graph":
        """Build from an in-memory raw edge list (e.g. the RMAT generator)."""
        if mesh is None:
            mesh = make_mesh()
        return cls._from_raw(np.asarray(r), np.asarray(c),
                             None if w is None else np.asarray(w), config, mesh)

    @classmethod
    def _from_raw(cls, r, c, w, config: GraphConfig, mesh: Mesh,
                  distributed: bool = False) -> "Graph":
        r, c, w = apply_transforms(
            r, c, w,
            directed=config.directed, transpose=config.transpose,
            self_loops=config.self_loops, acyclic=config.acyclic)
        nv = config.num_vertices + 1
        if r.size and max(int(r.max()), int(c.max())) >= nv:
            raise ValueError("edge endpoint exceeds num_vertices")
        R, C = mesh.devices.shape
        part = Partition.build(nv, R, C, segment_align=config.segment_align)
        if distributed:
            from graphtap.parallel.multihost import exchange_edges
            r, c, w = exchange_edges(r, c, w, part, mesh)
        return cls(config=config, part=part, mesh=mesh, r=r, c=c, w=w)

    def tiled(self, ordering: Ordering = Ordering.ROW,
              compression: Optional[Compression] = None) -> TileSet:
        """Build the TileSet for the requested ordering.

        ROW runs on the stored matrix; COL on its transpose (same edges,
        roles swapped) — the degree-on-A vs PR-on-Aᵀ trick of pr.cpp:41-47.
        """
        comp = compression or self.config.compression
        if ordering == Ordering.COL:
            r, c = self.c, self.r
        else:
            r, c = self.r, self.c
        return build_tileset(
            r, c, self.w, self.part, compression=comp,
            parallel_edges=self.config.parallel_edges,
            edge_align=self.config.edge_align)

    def tiled_cf(self, ordering: Ordering = Ordering.ROW) -> dict:
        """TCSC_CF phase tilesets (full/first/middle/last) — the
        computation-filtering execution plans (reference:
        compressed_column.hpp:606-1120)."""
        from graphtap.format.tiles import build_cf_tilesets
        if ordering == Ordering.COL:
            r, c = self.c, self.r
        else:
            r, c = self.r, self.c
        return build_cf_tilesets(
            r, c, self.w, self.part,
            parallel_edges=self.config.parallel_edges,
            edge_align=self.config.edge_align)
