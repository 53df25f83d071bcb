"""Backend-generic global algorithms over the unified edgeMap engine.

Counterpart of ``repro/core/traversal/algorithms.py``, as a text that
runs on both of the port's substrates: ``NumpyEngine`` (``ops.xp`` is
numpy) and ``TorchEngine`` (``ops.xp`` is a torch namespace bound to the
engine's device).  The reference's text calls numpy-only APIs
(``.astype``); here every cast goes through ``_cast``, and every array
constructor through ``ops.xp`` with an explicit dtype.

Contract v2: every F callback takes the per-edge value lane ``ws``
(None on unweighted engines).  BFS / CC / BC ignore it; SSSP and the
PageRank family consume it.  Single-source algorithms loop over rounds
on the host, one ``edge_map`` each (the paper's frontier-synchronous
model).  The ``*_multi`` variants dispatch to an engine's batched
traversals (``bfs_batch`` / ``bc_batch`` / ``sssp_batch`` /
``edge_map_reduce_batch``) and otherwise loop per source.  Results come
back as host numpy arrays.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .base import Counter, TraversalEngine

# Spy counter over PageRank power-iteration rounds (one bump per
# edge_map_reduce sweep).  The warm-start acceptance tests pin
# "incremental converges in <= half the rounds of full recompute" on
# the difference of this count across calls.
PAGERANK_ROUNDS = Counter()


def _cast(x, dtype):
    """``x.astype(dtype)`` for numpy arrays and torch tensors alike."""
    return x.to(dtype) if torch.is_tensor(x) else x.astype(dtype)


def _as_index(ops, v: int):
    return ops.xp.asarray([v], dtype=ops.int_dtype)


# ---------------------------------------------------------------------------
# BFS (direction-optimized, paper §5.1)
# ---------------------------------------------------------------------------


def _bfs_unvisited(ops, parents, vs):
    return parents[vs] < 0


def _bfs_relax(ops, parents, us, vs, ws, valid):
    """Claim parents: any in-frontier neighbor is a valid BFS parent;
    scatter-max resolves write contention deterministically."""
    cand = ops.scatter_max(ops.xp.full_like(parents, -1), vs, _cast(us, parents.dtype), valid)
    newly = (parents < 0) & (cand >= 0)
    return ops.xp.where(newly, cand, parents), newly


def bfs(engine: TraversalEngine, src: int, direction_optimize: bool = True) -> np.ndarray:
    """Parent array (-1 = unreached; src's parent is itself)."""
    ops = engine.ops
    parents = ops.set_at(
        ops.xp.full(engine.n, -1, dtype=ops.int_dtype), _as_index(ops, src), src
    )
    U = engine.frontier_from_ids([src])
    while not U.empty:
        U, parents = engine.edge_map(
            U, _bfs_relax, _bfs_unvisited, parents,
            direction_optimize=direction_optimize,
        )
    return engine.to_host(parents)


def bfs_multi(
    engine: TraversalEngine, sources, direction_optimize: bool = True
) -> tuple:
    """Multi-source BFS: ``(parents, depths)``, each int64[B, n].

    With ``direction_optimize`` on an engine exposing ``bfs_batch``
    (torch), all B traversals run as one batched loop; otherwise B
    serial ``bfs`` calls (the numpy fallback).  Parents agree between
    the two paths: both resolve write contention with the same
    max-parent rule."""
    sources = np.asarray(sources, dtype=np.int64).reshape(-1)
    n = engine.n
    batch = getattr(engine, "bfs_batch", None)
    if batch is not None and direction_optimize and sources.size:
        parents, depths = batch(sources)
        return (
            engine.to_host(parents).astype(np.int64),
            engine.to_host(depths).astype(np.int64),
        )
    ps, ds = [], []
    for s in sources:
        p = bfs(engine, int(s), direction_optimize=direction_optimize)
        ps.append(np.asarray(p, dtype=np.int64))
        ds.append(bfs_depths(p, int(s)))
    empty = np.empty((0, n), np.int64)
    return (np.stack(ps) if ps else empty, np.stack(ds) if ds else empty)


def landmark_distances(
    engine: TraversalEngine, landmarks, direction_optimize: bool = True
) -> np.ndarray:
    """Hop-distance rows int64[B, n] from each landmark (-1 =
    unreached): the distance-sketch building block — B columns of a
    landmark/distance-oracle table in one batched traversal."""
    return bfs_multi(engine, landmarks, direction_optimize=direction_optimize)[1]


def bfs_depths(parents: np.ndarray, src: int) -> np.ndarray:
    """Derive BFS levels from a parent array (host-side helper; used by
    the cross-backend parity checks, where parents may legally differ
    but depths may not)."""
    parents = np.asarray(parents)
    n = parents.size
    depth = np.full(n, -1, dtype=np.int64)
    depth[src] = 0
    for _ in range(n):
        unknown = (depth < 0) & (parents >= 0)
        if not unknown.any():
            break
        ready = unknown & (depth[parents] >= 0)
        if not ready.any():
            break
        depth[ready] = depth[parents[ready]] + 1
    return depth


# ---------------------------------------------------------------------------
# Connected components (min-label propagation through edgeMap)
# ---------------------------------------------------------------------------


def _cc_any(ops, labels, vs):
    return ops.xp.ones(vs.shape, dtype=bool)


def _cc_relax(ops, labels, us, vs, ws, valid):
    """Min-label relax over BOTH endpoints of each touched edge (the
    graph is undirected; each stored direction carries labels both
    ways, like the pre-refactor implementation)."""
    n = labels.shape[0]
    cand = ops.scatter_min(
        ops.xp.full(n, n, dtype=labels.dtype), vs, labels[us], valid
    )
    cand = ops.scatter_min(cand, us, labels[vs], valid)
    changed = cand < labels
    return ops.xp.where(changed, cand, labels), changed


def connected_components(
    engine: TraversalEngine, direction_optimize: bool = True, max_iters: int = 1000
) -> np.ndarray:
    """Min-label propagation to fixpoint; the frontier is the changed
    set, so converged regions stop costing work.

    Assumes the paper's undirected model: the edge set is symmetric
    (both directions stored), as AspenStream maintains by default.
    Frontier expansion follows stored out-edges, so on an asymmetric
    edge set vertices reachable only against edge direction may keep
    stale labels."""
    ops = engine.ops
    labels = ops.xp.arange(engine.n, dtype=ops.int_dtype)
    U = engine.frontier_all()
    for _ in range(max_iters):
        if U.empty:
            break
        U, labels = engine.edge_map(
            U, _cc_relax, _cc_any, labels, direction_optimize=direction_optimize
        )
    return engine.to_host(labels)


# ---------------------------------------------------------------------------
# PageRank (dense edgeMap reduced over the weighted (+, x) semiring)
# ---------------------------------------------------------------------------


def pagerank(
    engine: TraversalEngine,
    iters: int = 10,
    damping: float = 0.85,
    init: Optional[np.ndarray] = None,
    tol: Optional[float] = None,
    max_iters: int = 200,
) -> np.ndarray:
    """Power iteration over the weighted (+, x) semiring; the push step
    out[v] = sum_{u->v} w(u,v) * pr[u] / wdeg[u] is
    ``engine.edge_map_reduce`` — on the torch backend that's the CUDA
    segment-sum kernel (weighted variant on weighted graphs), on numpy
    a vectorized scatter-add.  ``wdeg`` is the weighted out-degree,
    which equals the plain degree on unweighted graphs — so this IS
    classic PageRank there (identical floats: a dangling vertex's value
    is never read by the reduce), and transition-probability-correct
    weighted PageRank on weighted graphs (mass is conserved because
    each vertex's outgoing weight normalizes to 1).

    ``init`` warm-starts the iteration (the incremental path passes the
    previous version's scores; shorter/longer rows are padded with 1/n
    / truncated for vertex-count changes).  The fixed point is unique
    for damping < 1, so any init converges to the same scores — init
    only changes how many rounds that takes.  ``tol`` switches from
    fixed ``iters`` to the fixed-point contract both the full and
    warm-started paths share: iterate until the L1 score change drops
    below ``tol`` (one host sync per round for the check), up to
    ``max_iters``.  Every round bumps ``PAGERANK_ROUNDS``."""
    xp = engine.ops.xp
    n = engine.n
    wdeg = _cast(engine.weighted_degrees, engine.ops.float_dtype)
    dangling = wdeg == 0
    if init is None:
        pr = xp.full(n, 1.0 / n, dtype=engine.ops.float_dtype)
    else:
        init = np.asarray(init).reshape(-1)
        if init.size < n:  # vertex growth since the init was computed
            init = np.concatenate([init, np.full(n - init.size, 1.0 / n)])
        pr = xp.asarray(init[:n], dtype=engine.ops.float_dtype)
    rounds = max_iters if tol is not None else iters
    for _ in range(rounds):
        w = xp.where(dangling, 0.0, pr / xp.where(dangling, 1.0, wdeg))
        contrib = _cast(engine.edge_map_reduce(w), engine.ops.float_dtype)
        contrib = contrib + xp.where(dangling, pr, 0.0).sum() / n
        nxt = (1.0 - damping) / n + damping * contrib
        PAGERANK_ROUNDS.bump()
        if tol is not None and float(xp.abs(nxt - pr).sum()) < tol:
            pr = nxt
            break
        pr = nxt
    return engine.to_host(pr)


def weighted_pagerank(
    engine: TraversalEngine, iters: int = 10, damping: float = 0.85
) -> np.ndarray:
    """Weighted PageRank — the explicit name for the weighted (+, x)
    semiring text: ``pagerank`` above is already weight-aware (one
    algorithm text, both substrates, weighted or not), so this simply
    delegates; on an unweighted engine it returns exactly
    ``pagerank``'s output."""
    return pagerank(engine, iters=iters, damping=damping)


def pagerank_multi(
    engine: TraversalEngine,
    resets=None,
    iters: int = 10,
    damping: float = 0.85,
    init: Optional[np.ndarray] = None,
    tol: Optional[float] = None,
    max_iters: int = 200,
) -> np.ndarray:
    """B PageRank queries against one snapshot: float[B, n].

    ``resets`` is a (B, n) batch of personalization rows (each summing
    to 1); ``None`` runs one uniform row (global PageRank, matching
    ``pagerank``).  Dangling mass is redistributed by each lane's reset
    row — with the uniform row that reduces exactly to ``pagerank``'s
    ``/ n`` term.  Every iteration pushes ALL lanes through one
    ``edge_map_reduce_batch`` (on torch: one segment-sum kernel whose
    feature dim carries the lanes; weighted graphs dispatch the
    weighted kernel and normalize by weighted out-degree, like
    ``pagerank``).

    ``init`` / ``tol`` / ``max_iters`` mirror ``pagerank``'s fixed-point
    contract batch-wide: ``init`` (B, n) warm-starts every lane (columns
    pad with 1/n / truncate on vertex-count changes; each lane's fixed
    point is unique for damping < 1, so any init converges to the same
    scores), and ``tol`` switches from fixed ``iters`` to iterating
    until EVERY lane's L1 change drops below ``tol`` (one host sync per
    round), up to ``max_iters`` — the contract the result cache's
    carry-forward warm start relies on."""
    xp = engine.ops.xp
    fdt = engine.ops.float_dtype
    n = engine.n
    wdeg = _cast(engine.weighted_degrees, fdt)
    dangling = wdeg == 0
    if resets is None:
        resets = xp.full((1, n), 1.0 / n, dtype=fdt)
    else:
        resets = xp.asarray(resets, dtype=fdt)
    if init is None:
        pr = resets
    else:
        init = np.asarray(init, dtype=np.float64).reshape(len(resets), -1)
        if init.shape[1] < n:  # vertex growth since the init was computed
            pad = np.full((init.shape[0], n - init.shape[1]), 1.0 / n)
            init = np.concatenate([init, pad], axis=1)
        pr = xp.asarray(init[:, :n], dtype=fdt)
    denom = xp.where(dangling, 1.0, wdeg)[None, :]
    rounds = max_iters if tol is not None else iters
    for _ in range(rounds):
        w = xp.where(dangling[None, :], 0.0, pr / denom)
        contrib = _cast(engine.edge_map_reduce_batch(w), fdt)
        dang = xp.where(dangling[None, :], pr, 0.0).sum(axis=1, keepdims=True)
        nxt = (1.0 - damping) * resets + damping * (contrib + dang * resets)
        if tol is not None:
            PAGERANK_ROUNDS.bump()
            if float(xp.abs(nxt - pr).sum(axis=1).max()) < tol:
                pr = nxt
                break
        pr = nxt
    return engine.to_host(pr)


# ---------------------------------------------------------------------------
# SSSP (Bellman–Ford over the (min, +) semiring; weighted edgeMap)
# ---------------------------------------------------------------------------


def _sssp_any(ops, dist, vs):
    return ops.xp.ones(vs.shape, dtype=bool)


def _sssp_relax(ops, dist, us, vs, ws, valid):
    """Relax every frontier edge: cand[v] = min dist[u] + w(u, v);
    scatter-min resolves write contention.  ``ws is None`` (an
    unweighted engine) runs unit weights — hop distances, the BFS
    metric — decided at trace time."""
    vals = dist[us] + (1.0 if ws is None else _cast(ws, dist.dtype))
    cand = ops.scatter_min(ops.xp.full_like(dist, ops.xp.inf), vs, vals, valid)
    newly = cand < dist
    return ops.xp.where(newly, cand, dist), newly


def sssp(engine: TraversalEngine, src: int, direction_optimize: bool = True) -> np.ndarray:
    """Single-source shortest-path distances (float, +inf = unreached)
    by frontier-synchronous Bellman–Ford: the frontier is the set of
    vertices whose distance improved last round, each round is one
    ``edge_map`` with the Beamer rule intact (sparse relaxes only the
    frontier's out-edges; dense is the (min, +) pull over all
    candidates).  At most n-1 rounds for non-negative weights."""
    ops = engine.ops
    xp = ops.xp
    dist = ops.set_at(
        xp.full(engine.n, xp.inf, dtype=ops.float_dtype), _as_index(ops, src), 0.0
    )
    U = engine.frontier_from_ids([src])
    for _ in range(max(engine.n, 1)):
        if U.empty:
            break
        U, dist = engine.edge_map(
            U, _sssp_relax, _sssp_any, dist,
            direction_optimize=direction_optimize,
        )
    return engine.to_host(dist)


def sssp_multi(
    engine: TraversalEngine, sources, direction_optimize: bool = True
) -> np.ndarray:
    """B SSSP queries against one snapshot: distances float64[B, n].

    Uses the engine's batched ``sssp_batch`` when available
    (torch: the whole multi-source Bellman–Ford runs all lanes together,
    one host sync per round, like ``bfs_batch``); otherwise B serial ``sssp`` calls
    (the numpy fallback) — same call site, both substrates."""
    sources = np.asarray(sources, dtype=np.int64).reshape(-1)
    batch = getattr(engine, "sssp_batch", None)
    if batch is not None and direction_optimize and sources.size:
        return engine.to_host(batch(sources)).astype(np.float64)
    if not sources.size:
        return np.empty((0, engine.n), np.float64)
    return np.stack(
        [
            np.asarray(
                sssp(engine, int(s), direction_optimize=direction_optimize),
                np.float64,
            )
            for s in sources
        ]
    )


# ---------------------------------------------------------------------------
# Betweenness centrality (Brandes, single source; paper §7 "BC")
# ---------------------------------------------------------------------------


def _bc_unvisited(ops, state, vs):
    sigma, visited = state
    return ~visited[vs]


def _bc_forward(ops, state, us, vs, ws, valid):
    """sigma[v] += sum of sigma over in-frontier predecessors."""
    sigma, visited = state
    contrib = ops.scatter_add(
        ops.xp.zeros_like(sigma), vs, sigma[us], valid
    )
    newly = (~visited) & (contrib > 0)
    sigma = sigma + ops.xp.where(newly, contrib, 0.0)
    visited = visited | newly
    return (sigma, visited), newly


def _bc_next_level(ops, state, vs):
    dep, sigma, level_of, tgt = state
    return level_of[vs] == tgt


def _bc_backward(ops, state, us, vs, ws, valid):
    """dep[u] += sigma[u]/sigma[v] * (1 + dep[v]) over u@d -> v@d+1."""
    dep, sigma, level_of, tgt = state
    contrib = (sigma[us] / ops.xp.maximum(sigma[vs], 1e-30)) * (1.0 + dep[vs])
    dep = ops.scatter_add(dep, us, contrib, valid)
    return (dep, sigma, level_of, tgt), ops.xp.zeros(dep.shape[0], dtype=bool)


def bc(engine: TraversalEngine, src: int, direction_optimize: bool = True) -> np.ndarray:
    """Single-source betweenness contributions (Brandes forward pass to
    count shortest paths, level-synchronous backward accumulation)."""
    ops = engine.ops
    xp = ops.xp
    n = engine.n
    fdt = ops.float_dtype
    sigma = ops.set_at(xp.zeros(n, dtype=fdt), _as_index(ops, src), 1.0)
    visited = ops.set_at(xp.zeros(n, dtype=bool), _as_index(ops, src), True)
    level_of = ops.set_at(xp.full(n, -1, dtype=ops.int_dtype), _as_index(ops, src), 0)
    levels: List[object] = []
    U = engine.frontier_from_ids([src])
    d = 0
    while not U.empty:
        levels.append(U)
        U, (sigma, visited) = engine.edge_map(
            U, _bc_forward, _bc_unvisited, (sigma, visited),
            direction_optimize=direction_optimize,
        )
        d += 1
        level_of = _cast(xp.where(U.to_dense(), d, level_of), ops.int_dtype)
    dep = xp.zeros(n, dtype=fdt)
    for d in range(len(levels) - 2, -1, -1):
        tgt = xp.asarray(d + 1, dtype=ops.int_dtype)
        state = (dep, sigma, level_of, tgt)
        _, state = engine.edge_map(
            levels[d], _bc_backward, _bc_next_level, state,
            direction_optimize=direction_optimize,
        )
        dep = state[0]
    dep = ops.set_at(dep, _as_index(ops, src), 0.0)
    return engine.to_host(dep)


# ---------------------------------------------------------------------------
# Incremental (delta-aware) algorithms: warm-start from the previous
# version's result instead of recomputing from scratch.  The delta is the
# per-version update record ``versioning.Delta`` (captured by
# ``AspenStream._publish``); every function here relaxes over the NEW
# snapshot only, so conservative (superset) seed/dirty sets never cost
# correctness — only extra relaxation work.
# ---------------------------------------------------------------------------


def _hop_relax(ops, dist, us, vs, ws, valid):
    """``_sssp_relax`` at forced unit weight: the BFS hop metric on a
    weighted engine (incremental BFS ignores the value lane)."""
    vals = dist[us] + 1.0
    cand = ops.scatter_min(ops.xp.full_like(dist, ops.xp.inf), vs, vals, valid)
    newly = cand < dist
    return ops.xp.where(newly, cand, dist), newly


def _parent_claim(ops, state, us, vs, ws, valid):
    """One dense pass deriving BFS parents from final depths:
    parent(v) = max u with depth(u) = depth(v) - 1 and u->v — exactly
    the contention rule of ``_bfs_relax`` and the ``bfs_batch`` loops,
    so post-hoc parents match the full-recompute parents bit-for-bit."""
    depths, cand = state
    ok = valid & (depths[us] >= 0) & (depths[vs] == depths[us] + 1)
    cand = ops.scatter_max(cand, vs, _cast(us, cand.dtype), ok)
    return (depths, cand), ops.xp.zeros(depths.shape[0], dtype=bool)


def _sssp_parent_claim(ops, state, us, vs, ws, valid):
    """Shortest-path-tree parents from final distances: parent(v) =
    max u with dist(v) = dist(u) + w(u, v).  Equality is exact: dist(v)
    was produced by the same float op for the winning predecessor."""
    dist, cand = state
    w = 1.0 if ws is None else _cast(ws, dist.dtype)
    ok = valid & ops.xp.isfinite(dist[us]) & (dist[vs] == dist[us] + w)
    cand = ops.scatter_max(cand, vs, _cast(us, cand.dtype), ok)
    return (dist, cand), ops.xp.zeros(dist.shape[0], dtype=bool)


def _pad_rows(arr: np.ndarray, n: int, fill) -> np.ndarray:
    """Fit (B, n_prev) state rows to the current vertex count (edge
    inserts may grow the vertex set between versions)."""
    B, n_prev = arr.shape
    if n_prev == n:
        return arr
    if n_prev > n:
        return arr[:, :n]
    return np.concatenate([arr, np.full((B, n - n_prev), fill, arr.dtype)], axis=1)


def _dirty_closure(prev_parents: np.ndarray, pairs: np.ndarray) -> np.ndarray:
    """Vertices whose recorded shortest-path-tree edge is in ``pairs``
    (deleted, or weight-overwritten on weighted graphs), closed under
    tree descendants — the set whose previous distances can no longer
    be trusted.  Vertices OUTSIDE the closure keep exact distances:
    their recorded root path uses only clean tree edges (a broken tree
    edge dirties the whole subtree below it), deletions only ever
    increase distances, and the old distance stays achievable."""
    B, n = prev_parents.shape
    dirty = np.zeros((B, n), dtype=bool)
    pairs = pairs[(pairs[:, 0] < n) & (pairs[:, 1] < n) & (pairs[:, 0] != pairs[:, 1])]
    if pairs.size:
        for b in range(B):
            hit = prev_parents[b, pairs[:, 1]] == pairs[:, 0]
            dirty[b, pairs[hit, 1]] = True
    vid = np.arange(n, dtype=np.int64)[None, :]
    valid = (prev_parents >= 0) & (prev_parents != vid)
    par_safe = np.where(valid, prev_parents, 0)
    for _ in range(n):
        spread = np.take_along_axis(dirty, par_safe, axis=1) & valid & ~dirty
        if not spread.any():
            break
        dirty |= spread
    return dirty


def warm_distances(
    engine: TraversalEngine,
    dist0: np.ndarray,  # float[B, n], +inf = unknown/unreached
    frontier0: np.ndarray,  # bool[B, n] initial relax frontier
    unit: bool = False,
) -> np.ndarray:
    """(min, +) relaxation to fixpoint from ARBITRARY initial state —
    the warm-start engine under incremental BFS and SSSP.  Dispatches
    the batched ``sssp_batch_from`` when the backend has one
    (torch: the Bellman–Ford loop seeded with ``(dist0, frontier0)``
    instead of point sources); otherwise runs the backend-generic per-lane edge_map loop.
    ``unit=True`` forces unit weights (the hop metric) on weighted
    engines."""
    dist0 = np.asarray(dist0, np.float64)
    frontier0 = np.asarray(frontier0, bool)
    drv = getattr(engine, "sssp_batch_from", None)
    if drv is not None and dist0.shape[0]:
        return engine.to_host(drv(dist0, frontier0, unit=unit)).astype(np.float64)
    ops = engine.ops
    F = _hop_relax if (unit and engine.weighted) else _sssp_relax
    rows: List[np.ndarray] = []
    for b in range(dist0.shape[0]):
        dist = ops.xp.asarray(dist0[b], dtype=ops.float_dtype)
        U = engine.frontier_from_dense(frontier0[b])
        for _ in range(max(engine.n, 1)):
            if U.empty:
                break
            U, dist = engine.edge_map(U, F, _sssp_any, dist)
        rows.append(np.asarray(engine.to_host(dist), np.float64))
    return np.stack(rows) if rows else np.empty((0, engine.n), np.float64)


def parents_from_depths(engine: TraversalEngine, depths: np.ndarray) -> np.ndarray:
    """Derive BFS parents int64[B, n] from depth rows with the batched loops'
    max-contention rule.  Backends may expose a vectorized
    ``parents_from_depths``; the fallback is one dense edge_map pass
    per lane (works on every backend, including sharded)."""
    depths = np.asarray(depths, np.int64)
    drv = getattr(engine, "parents_from_depths", None)
    if drv is not None:
        return engine.to_host(drv(depths)).astype(np.int64)
    ops = engine.ops
    n = engine.n
    vid = np.arange(n, dtype=np.int64)
    rows: List[np.ndarray] = []
    for row in depths:
        state = (
            ops.xp.asarray(row, dtype=ops.int_dtype),
            ops.xp.full(n, -1, dtype=ops.int_dtype),
        )
        _, state = engine.edge_map(
            engine.frontier_all(), _parent_claim, _cc_any, state, mode="dense"
        )
        cand = np.asarray(engine.to_host(state[1]), np.int64)
        rows.append(np.where(row == 0, vid, np.where(row > 0, cand, -1)))
    return np.stack(rows) if rows else np.empty((0, n), np.int64)


def shortest_path_parents(
    engine: TraversalEngine, dist: np.ndarray, sources
) -> np.ndarray:
    """Shortest-path-tree parents int64[B, n] for SSSP distance rows
    (one dense support-claim pass per lane): the state incremental SSSP
    keeps so the next delta can compute its dirty subtree."""
    dist = np.asarray(dist, np.float64)
    sources = np.asarray(sources, np.int64).reshape(-1)
    ops = engine.ops
    n = engine.n
    rows: List[np.ndarray] = []
    for b in range(dist.shape[0]):
        state = (
            ops.xp.asarray(dist[b], dtype=ops.float_dtype),
            ops.xp.full(n, -1, dtype=ops.int_dtype),
        )
        _, state = engine.edge_map(
            engine.frontier_all(), _sssp_parent_claim, _cc_any, state, mode="dense"
        )
        cand = np.asarray(engine.to_host(state[1]), np.int64)
        row = np.where(np.isfinite(dist[b]), cand, -1)
        row[sources[b]] = sources[b]
        rows.append(row)
    return np.stack(rows) if rows else np.empty((0, n), np.int64)


def incremental_bfs(
    engine: TraversalEngine,
    sources,
    prev_parents: np.ndarray,
    prev_depths: np.ndarray,
    delta,
) -> tuple:
    """BFS over the new snapshot, revalidating only what the delta can
    have changed: vertices whose recorded parent edge was deleted (plus
    their tree descendants) reset to unknown, everything else keeps its
    depth, and the warm relaxation runs from the clean reached set —
    new edges improve through relaxation, the dirty region recomputes
    from its boundary.  Exact: returns the same ``(parents, depths)``
    as a full ``bfs_multi`` on the new snapshot."""
    sources = np.asarray(sources, np.int64).reshape(-1)
    n = engine.n
    B = sources.size
    lane = np.arange(B)
    prev_parents = _pad_rows(np.asarray(prev_parents, np.int64), n, -1)
    prev_depths = _pad_rows(np.asarray(prev_depths, np.int64), n, -1)
    dirty = _dirty_closure(prev_parents, delta.dels)
    dist0 = np.where(
        dirty | (prev_depths < 0), np.inf, prev_depths.astype(np.float64)
    )
    dist0[lane, sources] = 0.0
    dist = warm_distances(engine, dist0, np.isfinite(dist0), unit=True)
    depths = np.where(np.isfinite(dist), dist, -1.0).astype(np.int64)
    return parents_from_depths(engine, depths), depths


def incremental_sssp(
    engine: TraversalEngine,
    sources,
    prev_dist: np.ndarray,
    prev_parents: np.ndarray,
    delta,
) -> np.ndarray:
    """SSSP distances float64[B, n] over the new snapshot, warm-started
    from the previous version's distances + shortest-path-tree parents
    (``shortest_path_parents``).  Dirty = subtrees under deleted tree
    edges — and, on weighted engines, under re-inserted tree edges
    (an insert may OVERWRITE an existing edge's weight upward, so the
    old support is no longer trustworthy; unit-weight graphs skip
    this).  Exact vs a full ``sssp_multi`` on the new snapshot."""
    sources = np.asarray(sources, np.int64).reshape(-1)
    n = engine.n
    lane = np.arange(sources.size)
    prev_dist = _pad_rows(np.asarray(prev_dist, np.float64), n, np.inf)
    prev_parents = _pad_rows(np.asarray(prev_parents, np.int64), n, -1)
    pairs = (
        np.concatenate([delta.dels, delta.ins]) if engine.weighted else delta.dels
    )
    dirty = _dirty_closure(prev_parents, pairs)
    dist0 = np.where(dirty, np.inf, prev_dist)
    dist0[lane, sources] = 0.0
    return warm_distances(engine, dist0, np.isfinite(dist0), unit=False)


def incremental_connected_components(
    engine: TraversalEngine,
    prev_labels: np.ndarray,
    delta,
    direction_optimize: bool = True,
    max_iters: int = 1000,
) -> np.ndarray:
    """Min-label propagation seeded ONLY from the delta's endpoint
    frontier over the new snapshot.  Exact for insert-only deltas:
    previous labels are per-component minima, new edges only merge
    components, and the only label disagreements in the initial state
    sit across inserted edges — so propagation from their endpoints
    reaches every vertex whose label must drop.  Deletions can split
    components (old labels become unverifiable), so a delta with
    deletions — or no delta at all — falls back to the full
    ``connected_components`` fixpoint."""
    if delta is None or delta.has_deletions:
        return connected_components(
            engine, direction_optimize=direction_optimize, max_iters=max_iters
        )
    n = engine.n
    prev = np.asarray(prev_labels, np.int64).reshape(-1)
    if prev.size < n:  # new vertices label themselves
        prev = np.concatenate([prev, np.arange(prev.size, n, dtype=np.int64)])
    prev = prev[:n]
    seeds = delta.endpoints
    seeds = seeds[seeds < n]
    if seeds.size == 0:
        return prev
    ops = engine.ops
    labels = ops.xp.asarray(prev, dtype=ops.int_dtype)
    U = engine.frontier_from_ids(seeds)
    for _ in range(max_iters):
        if U.empty:
            break
        U, labels = engine.edge_map(
            U, _cc_relax, _cc_any, labels, direction_optimize=direction_optimize
        )
    return engine.to_host(labels)


def bc_multi(engine: TraversalEngine, sources) -> np.ndarray:
    """B single-source BC queries: dependency scores float64[B, n].

    Uses the engine's batched ``bc_batch`` when available (torch:
    all lanes together per Brandes phase); otherwise B serial ``bc`` calls.
    The two paths agree to float32 tolerance (the batched pull rounds
    reduce via segmented scans rather than scatter-adds, so float
    summation order differs)."""
    sources = np.asarray(sources, dtype=np.int64).reshape(-1)
    batch = getattr(engine, "bc_batch", None)
    if batch is not None and sources.size:
        return engine.to_host(batch(sources)).astype(np.float64)
    if not sources.size:
        return np.empty((0, engine.n), np.float64)
    return np.stack([np.asarray(bc(engine, int(s)), np.float64) for s in sources])
