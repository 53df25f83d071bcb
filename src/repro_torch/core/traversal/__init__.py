"""Unified edgeMap traversal engine: one algorithm text, three backends.

Counterpart of ``repro/core/traversal/__init__.py``.  See ``base.py``
for the backend contract, ``numpy_backend`` / ``torch_backend`` /
``sharded_backend`` for the substrates, and ``algorithms`` for the
backend-generic BFS / PageRank / CC / SSSP / BC.

Quick start::

    from repro_torch.core import graph as G, flat_graph as fg
    from repro_torch.core.traversal import make_engine, algorithms as talg

    eng_np = make_engine(G.flat_snapshot(g))                   # numpy
    eng_t = make_engine(fg.from_edges(n, edges, device="cuda"))  # torch
    eng_s = make_engine(sharded_graph_of_flat(eng_t.g, 8))         # sharded
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
from .sharded_backend import CompressedShardedEngine, ShardedEngine
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
    "ShardedEngine",
    "CompressedShardedEngine",
    "VertexSubset",
    "edge_map",
    "engine_of",
    "from_dense",
    "from_ids",
    "gather_csr",
    "algorithms",
    "make_engine",
    "flat_graph_of",
    "sharded_graph_of_flat",
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
    ``backend`` in {"numpy", "torch", "sharded"}).

    A ``FlatGraph`` gives a ``TorchEngine`` on the graph's own device (with
    ``backend="sharded"``, a ``ShardedEngine`` over its range-sharded
    pool), a ``CompressedPool`` a ``CompressedEngine``, a ``ShardedGraph``
    a ``ShardedEngine`` and a ``CompressedShardedGraph`` a
    ``CompressedShardedEngine``; anything with the FlatSnapshot protocol
    gives a ``NumpyEngine``, or with ``backend="torch"`` / ``"sharded"``
    an engine over a FlatGraph rebuilt on ``device`` (``None`` = cuda); a
    tree-level ``Graph`` is snapshotted first."""
    from ..flat_graph import CompressedPool, FlatGraph
    from ..graph import Graph, flat_snapshot
    from ..sharded_pool import CompressedShardedGraph, ShardedGraph

    if backend not in (None, "numpy", "torch", "sharded"):
        raise ValueError(
            f"unknown backend {backend!r}; expected 'numpy', 'torch' or 'sharded'")
    if isinstance(obj, CompressedPool):
        if backend in ("numpy", "sharded"):
            raise TypeError("CompressedPool is device-native; decompress first")
        return CompressedEngine(obj)
    if isinstance(obj, CompressedShardedGraph):
        if backend in ("numpy", "torch"):
            raise TypeError("CompressedShardedGraph is sharded-native")
        return CompressedShardedEngine(obj)
    if isinstance(obj, ShardedGraph):
        if backend in ("numpy", "torch"):
            raise TypeError("ShardedGraph is sharded-native; pass backend='sharded'")
        return ShardedEngine(obj)
    if isinstance(obj, FlatGraph):
        if backend == "numpy":
            raise TypeError("FlatGraph is device-native; build a FlatSnapshot for numpy")
        if backend == "sharded":
            return ShardedEngine(sharded_graph_of_flat(obj))
        return TorchEngine(obj)
    if isinstance(obj, Graph):
        obj = flat_snapshot(obj)
    if backend in ("torch", "sharded"):
        return make_engine(flat_graph_of(obj, device=device), backend=backend)
    return engine_of(obj)


def sharded_graph_of_flat(g, n_shards: int | None = None, mesh=None):
    """FlatGraph -> ShardedGraph: range-partition the sorted packed-key
    pool (and its value lane) into ``n_shards`` rows (``None`` =
    ``sharded_pool.default_n_shards()``), on the graph's own device with
    no host round trip of the keys, keeping ``mesh``'s block of rows
    (default ``pool_mesh``: every row on one rank, this rank's block under
    a process group).  O(m); streams keep a resident sharded mirror so
    queries never pay this per version."""
    from ..sharded_pool import ShardedGraph, default_n_shards, from_sorted_device, pool_mesh

    if n_shards is None:
        n_shards = default_n_shards()
    if mesh is None:
        mesh = pool_mesh(n_shards, g.keys.device)
    return ShardedGraph(from_sorted_device(g.keys, int(g.m), n_shards, g.weights, mesh=mesh),
                        g.n)


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
