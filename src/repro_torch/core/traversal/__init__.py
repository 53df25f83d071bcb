"""Unified edgeMap traversal engine: one algorithm text, two backends.

Counterpart of ``repro/core/traversal/__init__.py``.  See ``base.py``
for the backend contract, ``numpy_backend`` / ``torch_backend`` for the
substrates, and ``algorithms`` for the backend-generic BFS / PageRank /
CC / SSSP / BC.

Quick start::

    from repro_torch.core import graph as G, flat_graph as fg
    from repro_torch.core.traversal import make_engine, algorithms as talg

    eng_np = make_engine(G.flat_snapshot(g))                   # numpy
    eng_t = make_engine(fg.from_edges(n, edges, device="cuda"))  # torch
"""
from __future__ import annotations

import numpy as np

from . import algorithms
from .base import (
    DENSE_THRESHOLD_DENOM,
    HOST_SYNCS,
    TRACES,
    ArrayOps,
    Counter,
    TraversalEngine,
    dense_threshold,
)
from .numpy_backend import (
    NumpyEngine,
    VertexSubset,
    edge_map,
    engine_of,
    from_dense,
    from_ids,
    gather_csr,
)
from .torch_backend import CompressedEngine, TorchEngine

__all__ = [
    "DENSE_THRESHOLD_DENOM",
    "ArrayOps",
    "Counter",
    "TraversalEngine",
    "dense_threshold",
    "NumpyEngine",
    "TorchEngine",
    "CompressedEngine",
    "VertexSubset",
    "edge_map",
    "engine_of",
    "from_dense",
    "from_ids",
    "gather_csr",
    "algorithms",
    "make_engine",
    "flat_graph_of",
    "FLAT_REBUILDS",
    "ENGINE_BUILDS",
    "HOST_SYNCS",
    "TRACES",
]

# Counts FlatSnapshot -> FlatGraph host rebuilds (the O(m) path the
# resident mirror exists to avoid).
FLAT_REBUILDS = Counter()

# Counts engine constructions in the version-pinned engine cache
# (``AspenStream._engine_for``).
ENGINE_BUILDS = Counter()


def make_engine(obj, backend: str | None = None, device=None) -> TraversalEngine:
    """Engine for a snapshot object, dispatched on type (or forced by
    ``backend`` in {"numpy", "torch"}).

    A ``FlatGraph`` gives a ``TorchEngine`` on the graph's own device, a
    ``CompressedPool`` a ``CompressedEngine``; anything with the
    FlatSnapshot protocol gives a ``NumpyEngine``, or with
    ``backend="torch"`` a ``TorchEngine`` over a FlatGraph rebuilt on
    ``device`` (``None`` = cuda); a tree-level ``Graph`` is snapshotted
    first.  The sharded engine is not ported yet."""
    from ..flat_graph import CompressedPool, FlatGraph
    from ..graph import Graph, flat_snapshot

    if backend == "sharded":
        raise NotImplementedError(
            "the sharded engine is not ported yet (ROADMAP.md queue 1 item 12)"
        )
    if backend not in (None, "numpy", "torch"):
        raise ValueError(f"unknown backend {backend!r}; expected 'numpy' or 'torch'")
    if isinstance(obj, CompressedPool):
        if backend == "numpy":
            raise TypeError("CompressedPool is device-native; decompress first")
        return CompressedEngine(obj)
    if isinstance(obj, FlatGraph):
        if backend == "numpy":
            raise TypeError("FlatGraph is device-native; build a FlatSnapshot for numpy")
        return TorchEngine(obj)
    if isinstance(obj, Graph):
        obj = flat_snapshot(obj)
    if backend == "torch":
        return TorchEngine(flat_graph_of(obj, device=device))
    return engine_of(obj)


def flat_graph_of(snap, device=None):
    """FlatSnapshot -> FlatGraph (host-side O(m) CSR rebuild; weighted
    snapshots carry their per-edge values into the pool's value array).
    The fallback conversion: streams keep a resident mirror so queries
    never pay this per version (``FLAT_REBUILDS`` counts who does)."""
    from ..flat_graph import from_edges

    FLAT_REBUILDS.bump()
    offsets, nbrs = gather_csr(snap, np.arange(snap.n, dtype=np.int64))
    srcs = np.repeat(np.arange(snap.n, dtype=np.int64), np.diff(offsets))
    weights = snap.edge_weights(srcs, nbrs) if getattr(snap, "weighted", False) else None
    return from_edges(snap.n, np.stack([srcs, nbrs], axis=1), weights=weights, device=device)
