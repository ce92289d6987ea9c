"""Independent NumPy golden models of the reference applications.

These reproduce the reference's *semantics* (validated against the built
reference binary: CSC/DCSC/TCSC kernels on rmat10_1024 × 20 iters give
checksum 317.0177, V[0]=0.165455, V[1]=0.426287 — see BASELINE.md) without
sharing any code with either the reference or graphtap.
"""

from __future__ import annotations

import numpy as np

INF = 2147483647


def pagerank(src, dst, nv, niters, alpha=0.15):
    """GraphTap PageRank: out-degree d, but only vertices with in-edges get
    their degree (the I-masked handoff, vertex_program.hpp:476-483); pull
    update rank = α + (1-α)·Σ rank[u]/d[u]."""
    src = np.asarray(src); dst = np.asarray(dst)
    outdeg = np.bincount(src, minlength=nv).astype(np.float64)
    has_in = np.zeros(nv, bool)
    has_in[dst] = True
    d = np.where(has_in, outdeg, 0.0)
    v = np.full(nv, alpha)
    for _ in range(niters):
        x = np.where(d > 0, v / np.where(d > 0, d, 1), 0.0)
        y = np.bincount(dst, weights=x[src], minlength=nv)
        v = alpha + (1 - alpha) * y
    return v


def degree(src, dst, nv):
    return np.bincount(np.asarray(src), minlength=nv).astype(np.int64)


def _dedup(u, v, w=None):
    """Remove parallel edges keeping min weight (framework semantics)."""
    key = np.asarray(u) * np.int64(1 << 32) + np.asarray(v)
    if w is None:
        _, idx = np.unique(key, return_index=True)
        return u[idx], v[idx], None
    order = np.lexsort((w, key))
    key_s, u_s, v_s, w_s = key[order], u[order], v[order], w[order]
    keep = np.concatenate(([True], key_s[1:] != key_s[:-1]))
    return u_s[keep], v_s[keep], w_s[keep]


def bfs(src, dst, nv, root=0):
    """Undirected level-synchronous BFS; parent = min vid among the
    previous level's neighbors (min combiner). Self-loops removed,
    parallel edges deduped (bfs.cpp:30-32). Returns (parent, hops)."""
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    keep = u != v
    u, v = u[keep], v[keep]
    u, v, _ = _dedup(u, v)
    parent = np.zeros(nv, dtype=np.int64)
    hops = np.full(nv, INF, dtype=np.int64)
    hops[root] = 0
    parent[root] = root
    frontier = np.zeros(nv, bool)
    frontier[root] = True
    it = 0
    while frontier.any():
        # messages: min vid over frontier in-neighbors
        m = np.full(nv, INF, dtype=np.int64)
        active = frontier[u]
        np.minimum.at(m, v[active], u[active])
        newly = (hops == INF) & (m != INF)
        hops[newly] = it + 1
        parent[newly] = m[newly]
        frontier = newly
        it += 1
    return parent, hops


def cc(src, dst, nv):
    """Undirected min-label propagation to fixpoint (self-loops kept,
    parallel edges deduped — cc.cpp:28-30)."""
    u = np.concatenate([src, dst])
    v = np.concatenate([dst, src])
    label = np.arange(nv, dtype=np.int64)
    while True:
        m = np.full(nv, INF, dtype=np.int64)
        np.minimum.at(m, v, label[u])
        new = np.minimum(label, m)
        if np.array_equal(new, label):
            return label
        label = new


def sssp(src, dst, w, nv, root=0):
    """Directed min-plus Bellman-Ford to fixpoint; self-loops removed,
    parallel edges deduped keeping min weight (framework dedup semantics)."""
    keep = src != dst
    u, v, ww = src[keep], dst[keep], w[keep]
    u, v, ww = _dedup(u, v, ww)
    dist = np.full(nv, INF, dtype=np.int64)
    dist[root] = 0
    while True:
        m = np.full(nv, INF, dtype=np.int64)
        reach = dist[u] != INF
        np.minimum.at(m, v[reach], dist[u][reach] + ww[reach])
        new = np.minimum(dist, m)
        if np.array_equal(new, dist):
            return dist
        dist = new
