"""Numpy traversal backend over ``FlatSnapshot`` (paper §5.1).

This is the CPU engine: the vertexSubset / edgeMap machinery formerly
in ``repro.core.edgemap`` plus the frontier loops formerly inlined in
``repro.core.algorithms``, refactored behind the backend contract in
``base.py``.  (The ``repro.core.edgemap`` re-export shim is gone;
import from ``repro.core.traversal``.)

The map/cond functions are vectorized over numpy arrays (the paper's
CPU parallel-for maps to vector lanes here).  Sparse ("push") direction
decodes only the frontier's adjacency lists from the snapshot; dense
("pull") direction scans candidates' in-neighbors via a reverse CSR
cached per snapshot, so it is direction-exact even on asymmetric edge
sets (matching the jax backend).

Port copy of ``repro/core/traversal/numpy_backend.py`` (numpy only), unchanged apart from this note.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np

from .base import DENSE_THRESHOLD_DENOM, ArrayOps, TraversalEngine, dense_threshold


class VertexSubset(NamedTuple):
    n: int
    ids: Optional[np.ndarray] = None  # sparse form (sorted, unique)
    dense: Optional[np.ndarray] = None  # bool[n]

    @property
    def size(self) -> int:
        return int(self.dense.sum()) if self.dense is not None else self.ids.size

    def to_sparse(self) -> np.ndarray:
        return self.ids if self.ids is not None else np.flatnonzero(self.dense)

    def to_dense(self) -> np.ndarray:
        if self.dense is not None:
            return self.dense
        d = np.zeros(self.n, dtype=bool)
        d[self.ids] = True
        return d

    @property
    def empty(self) -> bool:
        return self.size == 0


def from_ids(n: int, ids) -> VertexSubset:
    return VertexSubset(n, ids=np.unique(np.asarray(ids, dtype=np.int64)))


def from_dense(mask: np.ndarray) -> VertexSubset:
    return VertexSubset(mask.size, dense=mask)


def gather_csr(snap, vs: np.ndarray):
    """Concatenate neighbor lists of ``vs``: (offsets[len(vs)+1], nbrs).

    This is the chunk-decode work: O(sum deg) with O(log n + deg) per
    vertex on the tree level, O(deg) via the flat snapshot (paper §5.1).
    """
    lists = [snap.neighbors(int(v)) for v in vs]
    offsets = np.zeros(len(lists) + 1, dtype=np.int64)
    if lists:
        np.cumsum([l.size for l in lists], out=offsets[1:])
        nbrs = np.concatenate(lists) if offsets[-1] else np.empty(0, np.int64)
    else:
        nbrs = np.empty(0, np.int64)
    return offsets, nbrs


class NumpyOps(ArrayOps):
    xp = np
    int_dtype = np.int64
    float_dtype = np.float64

    def set_at(self, arr, idx, vals):
        out = arr.copy()
        out[idx] = vals
        return out

    def scatter_max(self, target, idx, vals, mask):
        out = target.copy()
        np.maximum.at(out, idx[mask], np.broadcast_to(vals, idx.shape)[mask])
        return out

    def scatter_min(self, target, idx, vals, mask):
        out = target.copy()
        np.minimum.at(out, idx[mask], np.broadcast_to(vals, idx.shape)[mask])
        return out

    def scatter_add(self, target, idx, vals, mask):
        out = target.copy()
        np.add.at(out, idx[mask], np.broadcast_to(vals, idx.shape)[mask])
        return out

    def scatter_or(self, target, idx, mask):
        out = target.copy()
        out[idx[mask]] = True
        return out


NP_OPS = NumpyOps()


class NumpyEngine(TraversalEngine):
    """Engine over any object with the FlatSnapshot protocol:
    ``.n``, ``.neighbors(v)``, ``.degree(v)`` (and optionally cached
    ``.degrees`` / ``.m``, which ``graph.FlatSnapshot`` provides).
    Weighted snapshots additionally expose ``.weighted`` and
    ``.edge_weights(srcs, dsts)`` (vectorized per-edge values), which
    the engine threads into the ``ws`` lane of every F callback and
    into the weighted ``edge_map_reduce`` semiring."""

    ops = NP_OPS

    def __init__(self, snap):
        self.snap = snap
        self._n = int(snap.n)
        degs = getattr(snap, "degrees", None)
        if degs is None:
            degs = np.fromiter(
                (snap.degree(v) for v in range(self._n)), np.int64, count=self._n
            )
        self._degrees = np.asarray(degs, dtype=np.int64)
        m = getattr(snap, "m", None)
        self._m = int(self._degrees.sum()) if m is None else int(m)
        self._full_csr = None
        self._rev_csr_cache = None
        self._weighted = bool(getattr(snap, "weighted", False))
        self._csr_w: Optional[np.ndarray] = None
        self._csr_starts_cache: Optional[np.ndarray] = None
        self._wdeg: Optional[np.ndarray] = None
        self.last_mode: Optional[str] = None  # "sparse" | "dense" (for tests)

    # -- graph shape --------------------------------------------------------
    @property
    def n(self) -> int:
        return self._n

    @property
    def m(self) -> int:
        return self._m

    @property
    def degrees(self) -> np.ndarray:
        return self._degrees

    @property
    def weights(self) -> Optional[np.ndarray]:
        """Per-edge weights aligned with the full CSR (``_csr()``), or
        None on unweighted snapshots.  Materialized ONCE per engine
        (one vectorized lookup against the snapshot's weight export);
        every edgeMap round slices this cache by CSR position instead
        of re-deriving weights per selected edge."""
        if not self._weighted:
            return None
        if self._csr_w is None:
            srcs, nbrs = self._csr()
            self._csr_w = self.snap.edge_weights(srcs, nbrs)
        return self._csr_w

    @property
    def weighted_degrees(self) -> np.ndarray:
        if not self._weighted:
            return self._degrees.astype(np.float64)
        if self._wdeg is None:
            srcs, _ = self._csr()
            wdeg = np.zeros(self._n, dtype=np.float64)
            np.add.at(wdeg, srcs, self.weights)
            self._wdeg = wdeg
        return self._wdeg

    def _csr_starts(self) -> np.ndarray:
        """offsets[v] of the full CSR: vertex v's adjacency list (in
        ``snap.neighbors(v)`` order, the same order every gather uses)
        occupies csr positions [starts[v], starts[v] + deg(v))."""
        if self._csr_starts_cache is None:
            starts = np.zeros(self._n + 1, dtype=np.int64)
            np.cumsum(self._degrees, out=starts[1:])
            self._csr_starts_cache = starts
        return self._csr_starts_cache

    def _csr(self):
        """Cached full CSR (srcs, nbrs) for whole-graph passes."""
        if self._full_csr is None:
            offsets, nbrs = gather_csr(self.snap, np.arange(self._n, dtype=np.int64))
            srcs = np.repeat(np.arange(self._n, dtype=np.int64), np.diff(offsets))
            self._full_csr = (srcs, nbrs)
        return self._full_csr

    def _rev_csr(self):
        """Cached reverse CSR (in_offsets[n+1], in_srcs sorted by dst,
        in_w weights in the same order or None): the dense ("pull")
        direction scans candidates' IN-neighbors, so it must be
        direction-exact even on asymmetric edge sets (the jax backend
        is; symmetric graphs make the two views coincide).  Built once
        per snapshot, amortized over every dense round."""
        if self._rev_csr_cache is None:
            srcs, nbrs = self._csr()
            order = np.argsort(nbrs, kind="stable")
            in_srcs = srcs[order]
            sorted_dst = nbrs[order]
            in_offsets = np.searchsorted(
                sorted_dst, np.arange(self._n + 1, dtype=np.int64)
            )
            in_w = self.weights[order] if self._weighted else None
            self._rev_csr_cache = (in_offsets, in_srcs, in_w)
        return self._rev_csr_cache

    def parents_from_depths(self, depths) -> np.ndarray:
        """BFS parents int64[B, n] from depth rows: one vectorized
        maximum.at pass per lane over the cached CSR, the same
        max-contention rule (parent(v) = max u with depth(u) =
        depth(v) - 1 and u->v) as the per-round ``_bfs_relax`` scatter
        and the jax drivers' post-hoc pass — so incremental BFS parents
        match a full recompute's exactly."""
        srcs, nbrs = self._csr()
        vid = np.arange(self._n, dtype=np.int64)
        rows = []
        for row in np.asarray(depths, np.int64):
            ok = (row[srcs] >= 0) & (row[nbrs] == row[srcs] + 1)
            cand = np.full(self._n, -1, np.int64)
            np.maximum.at(cand, nbrs[ok], srcs[ok])
            rows.append(np.where(row == 0, vid, np.where(row > 0, cand, -1)))
        return np.stack(rows) if rows else np.empty((0, self._n), np.int64)

    # -- frontiers ----------------------------------------------------------
    def frontier_from_ids(self, ids) -> VertexSubset:
        return from_ids(self._n, ids)

    def frontier_from_dense(self, mask) -> VertexSubset:
        return from_dense(np.asarray(mask, dtype=bool))

    # -- edgeMap ------------------------------------------------------------
    def edge_map(
        self,
        U: VertexSubset,
        F: Callable,
        C: Callable,
        state,
        direction_optimize: bool = True,
        mode: str = "auto",
    ) -> Tuple[VertexSubset, object]:
        if U.empty:
            return from_dense(np.zeros(self._n, dtype=bool)), state
        us = U.to_sparse()
        if mode == "auto" and not direction_optimize:
            mode = "sparse"
        if mode == "auto":
            deg_u = int(self._degrees[us].sum())
            mode = "dense" if (us.size + deg_u) > dense_threshold(self._m) else "sparse"
        self.last_mode = mode
        if mode == "dense":
            return self._edge_map_dense(U, F, C, state)
        return self._edge_map_sparse(us, F, C, state)

    def _edge_map_sparse(self, us, F, C, state):
        offsets, nbrs = gather_csr(self.snap, us)
        degs = np.diff(offsets)
        srcs = np.repeat(us, degs)
        keep = C(NP_OPS, state, nbrs) if nbrs.size else np.empty(0, bool)
        u_e, v_e = srcs[keep], nbrs[keep]
        ws = None
        if self._weighted:
            # the frontier gather lists each vertex's neighbors in the
            # same order as the full CSR, so weights are a slice of the
            # per-engine cache at csr_starts[u] + within-list position
            # (no per-round key lookups)
            within = np.arange(nbrs.size) - np.repeat(offsets[:-1], degs)
            ws = self.weights[np.repeat(self._csr_starts()[us], degs) + within][keep]
        state, out = F(NP_OPS, state, u_e, v_e, ws, np.ones(u_e.size, dtype=bool))
        return from_dense(out), state

    def _edge_map_dense(self, U, F, C, state):
        in_u = U.to_dense()
        candidates = np.flatnonzero(C(NP_OPS, state, np.arange(self._n, dtype=np.int64)))
        if candidates.size == 0:
            return from_dense(np.zeros(self._n, dtype=bool)), state
        in_offsets, in_srcs, in_w = self._rev_csr()
        counts = in_offsets[candidates + 1] - in_offsets[candidates]
        starts = in_offsets[candidates]
        dsts = np.repeat(candidates, counts)
        pos = np.arange(dsts.size) - np.repeat(np.cumsum(counts) - counts, counts)
        gidx = np.repeat(starts, counts) + pos
        srcs = in_srcs[gidx]
        sel = in_u[srcs] if srcs.size else np.empty(0, bool)
        u_e, v_e = srcs[sel], dsts[sel]
        ws = in_w[gidx][sel] if in_w is not None else None
        state, out = F(NP_OPS, state, u_e, v_e, ws, np.ones(u_e.size, dtype=bool))
        return from_dense(out), state

    # -- dense semiring reduce (weighted (+, x): w == 1 when unweighted) ----
    def edge_map_reduce(self, values: np.ndarray) -> np.ndarray:
        srcs, nbrs = self._csr()
        out = np.zeros(self._n, dtype=np.result_type(values.dtype, np.float64))
        contrib = values[srcs]
        if self._weighted:
            contrib = contrib * self.weights
        np.add.at(out, nbrs, contrib)
        return out

    # -- vertexMap ----------------------------------------------------------
    def vertex_map(self, U: VertexSubset, P: Callable, state) -> VertexSubset:
        ids = U.to_sparse()
        keep = P(NP_OPS, state, ids)
        return VertexSubset(self._n, ids=ids[keep])


def engine_of(snap) -> NumpyEngine:
    """Engine for a snapshot, cached on the snapshot when it allows
    attribute assignment (``graph.FlatSnapshot`` reserves an ``_engine``
    slot) so repeated algorithm calls share the CSR caches."""
    eng = getattr(snap, "_engine", None)
    if isinstance(eng, NumpyEngine):
        return eng
    eng = NumpyEngine(snap)
    try:
        snap._engine = eng
    except (AttributeError, TypeError):
        pass  # foreign snapshot type: engine is per-call
    return eng


# ---------------------------------------------------------------------------
# legacy Ligra-style API (paper §2 signature; kept for existing callers)
# ---------------------------------------------------------------------------


def edge_map(
    snap,
    U: VertexSubset,
    F: Callable[[np.ndarray, np.ndarray], np.ndarray],
    C: Callable[[np.ndarray], np.ndarray],
    m: Optional[int] = None,
    direction_optimize: bool = True,
    F_dense: Optional[Callable] = None,
) -> VertexSubset:
    """EDGEMAP(G, U, F, C) -> U' with the original mutate-in-closure
    callbacks: F(us, vs) -> per-edge bool, C(vs) -> bool.  Adapter over
    ``NumpyEngine.edge_map`` (``m`` is now read from the snapshot and
    accepted only for backward compatibility).

    ``F_dense(candidates, offsets, nbrs, nbr_in_u)`` keeps the original
    custom-dense-direction hook: when supplied and the Beamer rule
    picks dense, the legacy candidate-scan layout is reproduced.
    """
    eng = engine_of(snap)

    if F_dense is not None and direction_optimize and not U.empty:
        us = U.to_sparse()
        deg_u = int(eng.degrees[us].sum())
        if (us.size + deg_u) > dense_threshold(eng.m):
            in_u = U.to_dense()
            candidates = np.flatnonzero(C(np.arange(eng.n, dtype=np.int64)))
            if candidates.size == 0:
                return VertexSubset(eng.n, ids=np.empty(0, dtype=np.int64))
            offsets, nbrs = gather_csr(snap, candidates)
            nbr_in_u = in_u[nbrs] if nbrs.size else np.empty(0, bool)
            out_mask = F_dense(candidates, offsets, nbrs, nbr_in_u)
            return VertexSubset(eng.n, ids=candidates[out_mask])

    def C2(ops, state, vs):
        return C(vs)

    def F2(ops, state, us, vs, ws, valid):
        out = np.zeros(eng.n, dtype=bool)
        if us.size:
            hit = F(us, vs)
            out[vs[hit]] = True
        return state, out

    out, _ = eng.edge_map(U, F2, C2, None, direction_optimize=direction_optimize)
    return VertexSubset(eng.n, ids=np.flatnonzero(out.to_dense()))
