"""Graph algorithms over Aspen snapshots (paper §7 "Algorithms").

Counterpart of ``repro/core/algorithms.py``, the same text (numpy and
the host tree; no kernel): the globals bind the port's generic
algorithms (``traversal.algorithms``) to its numpy engine, as the
reference binds its own.

Global: BFS, BC (single-source betweenness), MIS, plus PageRank and
label-propagation CC (extras beyond the paper's five).
Local:  2-hop, Local-Cluster (Nibble-Serial, [71, 72]).

The frontier-synchronous globals (BFS / BC / PageRank / CC) are thin
wrappers over the backend-generic implementations in
``repro_torch.core.traversal.algorithms`` bound to the numpy engine — the
same algorithm text also runs on the torch and sharded backends (see
``traversal.make_engine``).  MIS and the local algorithms keep their
direct implementations here.

All globals take a FlatSnapshot (paper §5.1: global algorithms can afford
the O(n) flat-snapshot and then pay O(deg(v)) per vertex, as CSR would);
locals run directly against the tree to model the no-snapshot regime.
"""
from __future__ import annotations

import numpy as np

from . import ctree as ct
from .graph import FlatSnapshot, Graph, find_vertex
from .traversal import gather_csr
from .traversal import algorithms as talg
from .traversal.numpy_backend import engine_of as _engine_of


# ---------------------------------------------------------------------------
# frontier-synchronous globals: numpy engine bound to the generic text
# ---------------------------------------------------------------------------


def bfs(snap: FlatSnapshot, src: int, direction_optimize: bool = True) -> np.ndarray:
    """Returns the parent array (-1 = unreached; src's parent is itself)."""
    return talg.bfs(_engine_of(snap), src, direction_optimize=direction_optimize)


def bc(snap: FlatSnapshot, src: int) -> np.ndarray:
    """Single-source betweenness contributions (paper §7: BC computes the
    contributions for shortest paths from one vertex)."""
    return talg.bc(_engine_of(snap), src)


def pagerank(snap: FlatSnapshot, iters: int = 10, damping: float = 0.85) -> np.ndarray:
    return talg.pagerank(_engine_of(snap), iters=iters, damping=damping)


def connected_components(snap: FlatSnapshot, max_iters: int = 1000) -> np.ndarray:
    """Label propagation (min-label) to fixpoint.  Assumes a symmetric
    edge set (the paper's undirected model; AspenStream's default)."""
    return talg.connected_components(_engine_of(snap), max_iters=max_iters)


# ---------------------------------------------------------------------------
# Maximal independent set (rootset-based, Luby-style rounds)
# ---------------------------------------------------------------------------


def mis(snap: FlatSnapshot, seed: int = 0) -> np.ndarray:
    """Bool mask of a maximal independent set."""
    n = snap.n
    rng = np.random.default_rng(seed)
    pri = rng.permutation(n)  # random priorities
    in_set = np.zeros(n, dtype=bool)
    removed = np.zeros(n, dtype=bool)
    remaining = np.arange(n, dtype=np.int64)
    while remaining.size:
        offsets, nbrs = gather_csr(snap, remaining)
        srcs = np.repeat(remaining, np.diff(offsets))
        alive_e = ~removed[nbrs]
        # u is a local max if no alive neighbor has higher priority
        worse = np.zeros(n, dtype=bool)
        hi = alive_e & (pri[nbrs] > pri[srcs])
        np.logical_or.at(worse, srcs[hi], True)
        winners = remaining[~worse[remaining]]
        in_set[winners] = True
        removed[winners] = True
        # remove neighbors of winners
        w_off, w_nbrs = gather_csr(snap, winners)
        removed[w_nbrs] = True
        remaining = remaining[~removed[remaining]]
    return in_set


def verify_mis(snap: FlatSnapshot, in_set: np.ndarray) -> bool:
    n = snap.n
    for v in range(n):
        nbrs = snap.neighbors(v)
        if in_set[v]:
            if in_set[nbrs].any():
                return False
        else:
            if not in_set[nbrs].any() and nbrs.size:
                return False
    return True


# ---------------------------------------------------------------------------
# Local algorithms (run against the tree, no flat snapshot — paper §5.1)
# ---------------------------------------------------------------------------


def two_hop(g: Graph, src: int) -> np.ndarray:
    """Vertices within 2 hops of src (local query; tree access)."""
    et = find_vertex(g, src)
    if et is None:
        return np.empty(0, dtype=np.int64)
    one = ct.to_array(et)
    parts = [one]
    for u in one.tolist():
        eu = find_vertex(g, int(u))
        if eu is not None:
            parts.append(ct.to_array(eu))
    out = np.unique(np.concatenate(parts)) if parts else np.empty(0, np.int64)
    return out[out != src]


def local_cluster(
    g: Graph, src: int, eps: float = 1e-6, T: int = 10, alpha: float = 0.15
) -> np.ndarray:
    """Nibble-Serial ([71, 72]): truncated random-walk heat-kernel cluster.

    Sequential by design (paper runs many concurrently); returns the
    cluster's vertex ids.
    """
    p = {src: 1.0}
    for _ in range(T):
        nxt: dict = {}
        for v, mass in p.items():
            if mass < eps:
                continue
            et = find_vertex(g, int(v))
            nbrs = ct.to_array(et) if et is not None else np.empty(0, np.int64)
            keep = alpha * mass
            nxt[v] = nxt.get(v, 0.0) + keep
            if nbrs.size:
                share = (1 - alpha) * mass / nbrs.size
                for u in nbrs.tolist():
                    nxt[u] = nxt.get(u, 0.0) + share
        p = nxt
    verts = np.asarray(sorted(p, key=p.get, reverse=True), dtype=np.int64)
    mass = np.asarray([p[int(v)] for v in verts])
    cut = max(1, int((mass.cumsum() <= 0.9 * mass.sum()).sum()))
    return np.sort(verts[:cut])


