"""Checkpoint / resume for long executions.

The reference has no persistence at all — results are printed, never
written (SURVEY §5: the only durable artifact is the input edge list).
For long convergence runs on large graphs this module adds the cheap
capability the reference lacks: snapshot the vertex-state pytree plus the
changed bitmap and iteration counter, and restore them into a freshly
constructed Executor (the graph itself is rebuilt from the edge list,
which is deterministic given the same config/mesh).

Format: a single ``.npz`` per checkpoint (host-side numpy), one array per
state leaf plus ``__changed__`` and ``__iteration__``. On multi-host
meshes each process must see the full arrays (state leaves are small —
O(vertices), not O(edges)); process 0 writes, all processes read.
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING

import numpy as np

import jax

if TYPE_CHECKING:  # pragma: no cover
    from graphtap.engine.executor import Executor

_META_KEY = "__meta__"
_CHANGED_KEY = "__changed__"


def save_state(ex: "Executor", path: str) -> None:
    """Snapshot an executor's iteration state to ``path`` (.npz)."""
    if ex.state is None:
        raise ValueError("executor has no state; call initialize() first")
    arrays = {k: np.asarray(v) for k, v in ex.state.items()}
    if any(k.startswith("__") for k in arrays):
        raise ValueError("state keys must not start with '__'")
    arrays[_CHANGED_KEY] = np.asarray(ex.changed)
    meta = {
        "iteration": ex.iteration,
        "nv": ex.graph.nv,
        "program": type(ex.program).__name__,
        "mesh": list(ex.mesh.devices.shape),
    }
    arrays[_META_KEY] = np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8)
    if jax.process_index() == 0:
        np.savez(path, **arrays)


def load_state(ex: "Executor", path: str) -> int:
    """Restore a snapshot into ``ex``; returns the saved iteration count.

    The executor must be built over the same graph/mesh/partition as the
    one that wrote the snapshot (shape-checked)."""
    with np.load(path) as z:
        meta = json.loads(bytes(z[_META_KEY]).decode())
        if meta["nv"] != ex.graph.nv:
            raise ValueError(
                f"checkpoint nv={meta['nv']} != graph nv={ex.graph.nv}")
        if meta["mesh"] != list(ex.mesh.devices.shape):
            raise ValueError(
                f"checkpoint mesh {meta['mesh']} != executor mesh "
                f"{list(ex.mesh.devices.shape)}")
        changed = z[_CHANGED_KEY]
        state = {k: z[k] for k in z.files
                 if k not in (_META_KEY, _CHANGED_KEY)}
    ex.state = {k: ex._put(v) for k, v in state.items()}
    ex.changed = ex._put(changed.astype(bool))
    ex.iteration = int(meta["iteration"])
    return ex.iteration
