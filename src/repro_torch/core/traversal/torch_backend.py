"""PyTorch traversal backend over ``FlatGraph`` (the packed-key pool) and
``CompressedPool`` (the chunk-compressed pool).

Counterpart of ``repro/core/traversal/jax_backend.py`` (lines 81-1479).
Ligra's edgeMap maps onto the flat pool the same way:

  * dense ("pull") direction: every pool slot looks up whether its
    source is in the frontier — one gather plus one masked scatter.  The
    (+, x) specialization ``edge_map_reduce`` (PageRank's inner loop)
    runs on the hand-written segment-sum kernels
    (``repro_torch.kernels.ops.segment_sum(_weighted)``) over the
    dst-major permutation of the pool;
  * sparse ("push") direction: the frontier's adjacency lists are
    contiguous key ranges of the sorted pool, so expansion is a
    fixed-budget ragged gather — a static-size nonzero of the frontier,
    a searchsorted over the per-id degree prefix sums, pool indices.

Where the reference differs from eager PyTorch:

  * ``lax.cond`` and ``lax.while_loop`` become host control flow.  Each
    round reads the stop test and the Beamer decision in ONE sync
    (``base.py`` states the per-round contract);
  * ``mode="drop"`` scatters become scatters into one sink slot past the
    end, which is sliced off (``TorchOps``);
  * ``jnp.nonzero(size=K, fill_value=n)`` becomes a cumsum-and-scatter
    with the same budgets, so the sparse expansion has the reference's
    shapes and results;
  * float segment sums over contiguous segments (``weighted_degrees``,
    the BC rounds) are true segment sums on the kernel, not the
    reference's float cumsum-difference, which cancels at scale
    (ROADMAP.md §3).  The integer BFS pull keeps the prefix sum, which is
    exact.

``CompressedEngine`` serves the same query loops from a compressed resident
snapshot: each query decodes the pool and the aux lanes it reads
(``_inflate``, through ``compressed.decode_rows``, which runs the chunked
decode kernels on the card; the reference decodes in XLA), and
``edge_map_reduce`` decodes its source lane the same way while its
chunked segment-sum kernels decode the dst lane inside the kernel.

Precision: state and reduces are float32, the reference's default.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...kernels import ops as kops
from .. import compressed as cz
from ..flat_graph import CompressedPool, FlatGraph, decompress, unpack
from .base import DENSE_THRESHOLD_DENOM, HOST_SYNCS, ArrayOps, TraversalEngine


def _sync(*flags: torch.Tensor) -> list:
    """One blocking device->host read of a few scalars (one HOST_SYNCS).
    A flag laid out over ranks (a DTensor) is read as its logical value,
    the same on every rank."""
    HOST_SYNCS.bump()
    flags = [f.full_tensor() if hasattr(f, "full_tensor") else f for f in flags]
    return torch.stack([f.reshape(()).to(torch.int64) for f in flags]).tolist()


class TorchNamespace:
    """The numpy-style subset of ``xp`` that ``algorithms.py`` calls,
    with every constructor bound to one device."""

    inf = math.inf

    def __init__(self, device: torch.device):
        self.device = device

    def full(self, shape, fill, dtype=None):
        return torch.full(_shape(shape), fill, dtype=dtype, device=self.device)

    def zeros(self, shape, dtype=None):
        return torch.zeros(_shape(shape), dtype=dtype, device=self.device)

    def ones(self, shape, dtype=None):
        return torch.ones(_shape(shape), dtype=dtype, device=self.device)

    def arange(self, n, dtype=None):
        return torch.arange(n, dtype=dtype, device=self.device)

    def asarray(self, x, dtype=None):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    @staticmethod
    def maximum(a, b):
        if not torch.is_tensor(b):
            return torch.clamp(a, min=b)
        return torch.maximum(a, b)

    full_like = staticmethod(torch.full_like)
    zeros_like = staticmethod(torch.zeros_like)
    where = staticmethod(torch.where)
    abs = staticmethod(torch.abs)
    isfinite = staticmethod(torch.isfinite)


def _shape(shape) -> tuple:
    return tuple(shape) if isinstance(shape, (tuple, list, torch.Size)) else (int(shape),)


class TorchOps(ArrayOps):
    """Masked scatter helpers for F/C callbacks.  Masked lanes are routed
    to a sink slot at index ``len(target)`` and sliced off."""

    int_dtype = torch.int32
    float_dtype = torch.float32

    def __init__(self, device: torch.device):
        self.device = device
        self.xp = TorchNamespace(device)

    def set_at(self, arr, idx, vals):
        out = arr.clone()
        out[idx] = vals
        return out

    @staticmethod
    def _ext(target, idx, vals, mask):
        n = target.shape[0]
        ext = torch.cat([target, target[:1]])
        safe = torch.where(mask, idx.long(), n)
        src = torch.as_tensor(vals, dtype=target.dtype, device=target.device)
        return ext, safe, src.expand(safe.shape)

    def _reduce(self, target, idx, vals, mask, how):
        ext, safe, src = self._ext(target, idx, vals, mask)
        return ext.scatter_reduce_(0, safe, src, how, include_self=True)[:-1]

    def scatter_max(self, target, idx, vals, mask):
        return self._reduce(target, idx, vals, mask, "amax")

    def scatter_min(self, target, idx, vals, mask):
        return self._reduce(target, idx, vals, mask, "amin")

    def scatter_add(self, target, idx, vals, mask):
        ext, safe, src = self._ext(target, idx, vals, mask)
        src = torch.where(mask, src, torch.zeros((), dtype=target.dtype, device=target.device))
        return ext.index_add_(0, safe, src)[:-1]

    def scatter_or(self, target, idx, mask):
        n = target.shape[0]
        ext = torch.cat([target, target[:1]])
        ext[torch.where(mask, idx.long(), n)] = True
        return ext[:-1]


class TorchVertexSubset:
    """Dense bool[n] frontier.  ``size``/``empty`` read the frontier size
    and its out-degree sum in ONE sync and cache both, so the caller's
    stop test and the next edge_map's Beamer decision share it."""

    __slots__ = ("dense", "_degrees", "_stats")

    def __init__(self, dense: torch.Tensor, degrees: torch.Tensor):
        self.dense = dense
        self._degrees = degrees
        self._stats: Optional[Tuple[int, int]] = None

    @property
    def n(self) -> int:
        return self.dense.shape[0]

    def stats(self) -> Tuple[int, int]:
        """(|U|, deg(U)); one host sync, cached."""
        if self._stats is None:
            deg = torch.where(self.dense, self._degrees, 0).sum()
            size, deg = _sync(self.dense.sum(), deg)
            self._stats = (size, deg)
        return self._stats

    @property
    def size(self) -> int:
        return self.stats()[0]

    @property
    def empty(self) -> bool:
        return self.size == 0

    def to_dense(self) -> torch.Tensor:
        return self.dense

    def to_sparse(self) -> np.ndarray:
        return np.flatnonzero(self.dense.cpu().numpy())


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


# ---------------------------------------------------------------------------
# per-snapshot engine auxiliary state
# ---------------------------------------------------------------------------


class EngineAux(NamedTuple):
    """Everything ``TorchEngine`` derives from a snapshot, built once per
    version on the device (``engine_aux``).  ``w_by_dst`` is the value
    array permuted dst-major, None on unweighted graphs."""

    src_c: torch.Tensor  # int32[cap] clipped sources
    dst_c: torch.Tensor  # int32[cap] clipped destinations
    evalid: torch.Tensor  # bool[cap] slot < m and dst a real vertex
    degrees: torch.Tensor  # int32[n]
    dst_sorted: torch.Tensor  # int32[cap] destinations ascending (pad = n)
    src_by_dst: torch.Tensor  # int32[cap] sources permuted dst-major
    valid_by_dst: torch.Tensor  # bool[cap]
    dst_offsets: torch.Tensor  # int32[n+1] segment bounds into dst_sorted
    w_by_dst: Optional[torch.Tensor] = None  # float32[cap] values dst-major


def _pool_endpoints(g: FlatGraph):
    """(src_c, dst_c, evalid).  A slot is usable iff it holds a real edge
    AND its destination is a real vertex: an asymmetric stream can store
    an edge naming a never-source vertex id >= n, and every query
    direction drops it."""
    n = g.n
    src, dst = unpack(g.keys)
    evalid = (torch.arange(g.edge_capacity, device=g.device) < g.m) & (dst >= 0) & (dst < n)
    hi = max(n - 1, 0)
    return src.clamp(0, hi), dst.clamp(0, hi), evalid


def engine_aux(g: FlatGraph) -> EngineAux:
    n = g.n
    src_c, dst_c, evalid = _pool_endpoints(g)
    # dst-major permutation (the pool is src-major) for the segment-sum
    # kernel and the pull rounds; valid => dst == dst_c
    dst_key = torch.where(evalid, dst_c, n)
    dst_sorted, order = torch.sort(dst_key, stable=True)
    return EngineAux(
        src_c=src_c,
        dst_c=dst_c,
        evalid=evalid,
        degrees=torch.diff(g.offsets),
        dst_sorted=dst_sorted,
        src_by_dst=src_c[order],
        valid_by_dst=evalid[order],
        dst_offsets=torch.searchsorted(
            dst_sorted, torch.arange(n + 1, dtype=torch.int32, device=g.device)
        ).to(torch.int32),
        w_by_dst=None if g.weights is None else g.weights[order],
    )


def _src_key(g: FlatGraph) -> torch.Tensor:
    """The src-major pool's segment key for the kernel: src for slots < m
    (ascending, the pool is sorted), n for pad slots."""
    slot = torch.arange(g.edge_capacity, device=g.device)
    return torch.where(slot < g.m, g.keys >> 32, g.n).to(torch.int32)


# ---------------------------------------------------------------------------
# the edgeMap step
# ---------------------------------------------------------------------------


def _sparse_expand(offsets, keys, U_b, n: int, ids_budget: int, edge_budget: int):
    """Fixed-budget push expansion of a (B, n) frontier batch:
    (us, vs, ev, eidx), each (B, edge_budget).  ``ev`` masks the padded
    tail and edges naming nonexistent destinations; ``eidx`` is each
    lane's pool slot.  The static-size nonzero keeps the first
    ``ids_budget`` frontier ids per row, as ``jnp.nonzero(size=)`` does."""
    dev = U_b.device
    B = U_b.shape[0]
    pos = torch.cumsum(U_b, 1) - 1
    slot = torch.where(U_b & (pos < ids_budget), pos, ids_budget)
    ids_raw = torch.full((B, ids_budget + 1), n, dtype=torch.int64, device=dev)
    ids_raw.scatter_(1, slot, torch.arange(n, device=dev).expand(B, n))
    ids_raw = ids_raw[:, :ids_budget]
    vid = ids_raw < n
    ids = torch.where(vid, ids_raw, 0)
    offs = offsets.long()
    starts = offs[ids]
    degs = torch.where(vid, offs[ids + 1] - starts, 0)
    cum = torch.cumsum(degs, 1)
    j = torch.arange(edge_budget, device=dev).expand(B, edge_budget).contiguous()
    seg = torch.searchsorted(cum, j, right=True).clamp_(0, ids_budget - 1)
    prev = torch.where(seg > 0, cum.gather(1, (seg - 1).clamp_(min=0)), 0)
    eidx = starts.gather(1, seg) + (j - prev)
    ev = j < cum[:, -1:]
    eidx = torch.where(ev, eidx, 0)
    vs_raw = keys[eidx] & 0xFFFFFFFF  # int64: no wraparound
    ev = ev & (vs_raw < n)
    vs = vs_raw.clamp(0, n - 1).to(torch.int32)
    us = ids.gather(1, seg).to(torch.int32)
    return us, vs, ev, eidx


def _use_dense(f_b, degrees, thresh):
    """The batched Beamer rule: dense iff ANY lane is over threshold."""
    size_b = f_b.sum(1)
    deg_b = torch.where(f_b, degrees[None, :], 0).sum(1)
    return ((size_b + deg_b) > thresh).any()


def _thresh(g: FlatGraph) -> torch.Tensor:
    return torch.clamp(g.m // DENSE_THRESHOLD_DENOM, min=1)


def _reduce_msgs(values, src_by_dst, valid_by_dst):
    return torch.where(valid_by_dst, values[src_by_dst.long()], 0).float()


def _reduce_msgs_batch(values_b, src_by_dst, valid_by_dst):
    # (B, n) value rows -> (cap, B) dst-major message columns
    msg = torch.where(valid_by_dst[None, :], values_b[:, src_by_dst.long()], 0)
    return msg.T.float().contiguous()


# ---------------------------------------------------------------------------
# segmented row reductions over a contiguously segmented pool axis
# ---------------------------------------------------------------------------


def _segsum_rows_int(msg_b: torch.Tensor, bounds: torch.Tensor) -> torch.Tensor:
    """Integer (B, cap) messages -> (B, S) segment sums by prefix sum and
    boundary difference: exact in integers, and scatter-free."""
    csum = torch.cumsum(msg_b, 1, dtype=torch.int32)
    padded = torch.cat([torch.zeros_like(csum[:, :1]), csum], 1)
    b = bounds.long()
    return padded[:, b[1:]] - padded[:, b[:-1]]


def _segsum_rows_float(msg_b: torch.Tensor, seg_key: torch.Tensor, n: int) -> torch.Tensor:
    """Float (B, cap) messages -> (B, n) true segment sums on the kernel;
    ``seg_key`` is the ascending segment id per slot (pad >= n)."""
    out = kops.segment_sum(seg_key, msg_b.T.to(torch.float32).contiguous(), n)
    return out.T.to(msg_b.dtype)


def _seg_reduce_rows(msg_b, dst_sorted, n: int, fill, how: str):
    """(B, cap) messages -> (B, n) segment max/min keyed by ``dst_sorted``
    (pad slots key n, a sink column); empty segments give ``fill``."""
    B = msg_b.shape[0]
    out = torch.full((B, n + 1), fill, dtype=msg_b.dtype, device=msg_b.device)
    idx = dst_sorted.long()[None, :].expand(B, -1)
    return out.scatter_reduce_(1, idx, msg_b, how, include_self=True)[:, :n]


# ---------------------------------------------------------------------------
# batched traversals: whole multi-source loops, one sync per round
# ---------------------------------------------------------------------------


def _lanes(sources, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(sources, np.int64).reshape(-1), device=device)


def _push_reached(g, f_b, n, ids_budget, edge_budget):
    _, vs, ev, _ = _sparse_expand(g.offsets, g.keys, f_b, n, ids_budget, edge_budget)
    out = torch.zeros((f_b.shape[0], n + 1), dtype=torch.bool, device=f_b.device)
    out.scatter_(1, torch.where(ev, vs.long(), n), True)
    return out[:, :n]


def bfs_batch(
    g: FlatGraph, aux: EngineAux, sources, *, ids_budget: int, edge_budget: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-source direction-optimized BFS: ``(parents, depths)``
    int32[B, n] (-1 = unreached; a source's parent is itself).  Each round
    the batched Beamer rule picks push (budget-bounded expand) or pull
    (the (or, and) semiring over the dst-major pool as an integer
    segmented sum).  Parents come from one pass at the end
    (``_parents_pass``)."""
    n = g.n
    src = _lanes(sources, g.device)
    B = src.shape[0]
    lane = torch.arange(B, device=g.device)
    depths = torch.full((B, n), -1, dtype=torch.int32, device=g.device)
    depths[lane, src] = 0
    f = torch.zeros((B, n), dtype=torch.bool, device=g.device)
    f[lane, src] = True
    thresh = _thresh(g)
    d = 0
    while True:
        go, dense = _sync(f.any(), _use_dense(f, aux.degrees, thresh))
        if not go:
            break
        if dense:
            msg = (f[:, aux.src_by_dst.long()] & aux.valid_by_dst[None, :]).to(torch.int32)
            reached = _segsum_rows_int(msg, aux.dst_offsets) > 0
        else:
            reached = _push_reached(g, f, n, ids_budget, edge_budget)
        f = reached & (depths < 0)
        depths = torch.where(f, d + 1, depths)
        d += 1
    return _parents_pass(g, aux, depths), depths


def _parents_pass(g: FlatGraph, aux: EngineAux, depths: torch.Tensor) -> torch.Tensor:
    """BFS parents from final depths in ONE pass: parent(v) = max u with
    depth(u) = depth(v) - 1 and u->v — the max-contention rule of every
    backend — as a segment max over the dst-major pool."""
    n = g.n
    depths = torch.as_tensor(depths, device=g.device).to(torch.int32)
    src = aux.src_by_dst.long()
    du = depths[:, src]
    dv = depths[:, aux.dst_sorted.long().clamp_max(max(n - 1, 0))]  # pads masked
    ok = aux.valid_by_dst[None, :] & (du >= 0) & (dv == du + 1)
    msg = torch.where(ok, aux.src_by_dst[None, :], -1)
    cand = _seg_reduce_rows(msg, aux.dst_sorted, n, -1, "amax")
    vid = torch.arange(n, dtype=torch.int32, device=g.device)[None, :]
    return torch.where(depths == 0, vid, torch.where(depths > 0, cand, -1))


parents_from_depths = _parents_pass


def bc_batch(g: FlatGraph, aux: EngineAux, sources) -> torch.Tensor:
    """Multi-source Brandes dependency scores float[B, n].  Forward: sigma
    accumulates per-round shortest-path counts as a (+, x) segment sum
    over the dst-major pool; backward walks depths from the deepest round
    down, accumulating per SOURCE over the src-major pool.  Both reduces
    run on the segment-sum kernel."""
    n = g.n
    src = _lanes(sources, g.device)
    B = src.shape[0]
    lane = torch.arange(B, device=g.device)
    sigma = torch.zeros((B, n), device=g.device)
    sigma[lane, src] = 1.0
    depth = torch.full((B, n), -1, dtype=torch.int32, device=g.device)
    depth[lane, src] = 0
    f = torch.zeros((B, n), dtype=torch.bool, device=g.device)
    f[lane, src] = True
    sbd = aux.src_by_dst.long()
    d = 0
    while _sync(f.any())[0]:
        w = torch.where(f[:, sbd] & aux.valid_by_dst[None, :], sigma[:, sbd], 0)
        contrib = _segsum_rows_float(w, aux.dst_sorted, n)
        f = (contrib > 0) & (depth < 0)
        sigma = sigma + torch.where(f, contrib, 0)
        depth = torch.where(f, d + 1, depth)
        d += 1

    src_c, dst_c = aux.src_c.long(), aux.dst_c.long()
    du, dv = depth[:, src_c], depth[:, dst_c]
    ratio = sigma[:, src_c] / torch.clamp(sigma[:, dst_c], min=1e-30)
    src_key = _src_key(g)
    dep = torch.zeros((B, n), device=g.device)
    for dd in range(d - 2, -1, -1):
        ok = aux.evalid[None, :] & (du == dd) & (dv == dd + 1)
        contrib = torch.where(ok, ratio * (1.0 + dep[:, dst_c]), 0)
        dep = dep + _segsum_rows_float(contrib, src_key, n)
    dep[lane, src] = 0.0
    return dep


def _bellman_ford(
    g: FlatGraph,
    aux: EngineAux,
    dist: torch.Tensor,  # float[B, n] initial distances (+inf = unknown)
    frontier: torch.Tensor,  # bool[B, n] initial relax frontier
    *,
    ids_budget: int,
    edge_budget: int,
    unit: bool = False,
) -> torch.Tensor:
    """The (min, +) relaxation loop shared by ``sssp_batch`` and
    ``sssp_batch_from``; ``unit=True`` forces unit weights (the hop
    metric on a weighted pool)."""
    n = g.n
    cap = g.edge_capacity
    ones = torch.ones(cap, device=g.device)
    w_pool = ones if (unit or g.weights is None) else g.weights
    w_by_dst = ones if (unit or aux.w_by_dst is None) else aux.w_by_dst
    thresh = _thresh(g)
    sbd = aux.src_by_dst.long()
    f, d = frontier, dist
    while True:
        go, dense = _sync(f.any(), _use_dense(f, aux.degrees, thresh))
        if not go:
            break
        if dense:
            msg = torch.where(f[:, sbd] & aux.valid_by_dst[None, :],
                              d[:, sbd] + w_by_dst[None, :], math.inf)
            cand = _seg_reduce_rows(msg, aux.dst_sorted, n, math.inf, "amin")
        else:
            us, vs, ev, eidx = _sparse_expand(g.offsets, g.keys, f, n, ids_budget, edge_budget)
            vals = d.gather(1, us.long()) + w_pool[eidx]
            cand = torch.full((f.shape[0], n + 1), math.inf, device=g.device)
            cand = cand.scatter_reduce_(1, torch.where(ev, vs.long(), n), vals, "amin")[:, :n]
        f = cand < d
        d = torch.where(f, cand, d)
    return d


def sssp_batch(
    g: FlatGraph, aux: EngineAux, sources, *, ids_budget: int, edge_budget: int
) -> torch.Tensor:
    """Multi-source Bellman–Ford over the weighted (min, +) semiring:
    distances float[B, n] (+inf = unreached); unit weights on an
    unweighted graph."""
    src = _lanes(sources, g.device)
    B = src.shape[0]
    lane = torch.arange(B, device=g.device)
    dist = torch.full((B, g.n), math.inf, device=g.device)
    dist[lane, src] = 0.0
    frontier = torch.zeros((B, g.n), dtype=torch.bool, device=g.device)
    frontier[lane, src] = True
    return _bellman_ford(g, aux, dist, frontier, ids_budget=ids_budget,
                         edge_budget=edge_budget)


def sssp_batch_from(
    g: FlatGraph, aux: EngineAux, dist0, frontier0, *, ids_budget: int, edge_budget: int,
    unit: bool = False,
) -> torch.Tensor:
    """``sssp_batch`` seeded from arbitrary initial state (the warm-start
    entry point of incremental BFS/SSSP)."""
    dist0 = torch.as_tensor(np.asarray(dist0), device=g.device).float()
    frontier0 = torch.as_tensor(np.asarray(frontier0, bool), device=g.device)
    return _bellman_ford(g, aux, dist0, frontier0, ids_budget=ids_budget,
                         edge_budget=edge_budget, unit=unit)


class TorchEngine(TraversalEngine):
    """Engine over an (immutable) ``FlatGraph`` snapshot, on its device."""

    def __init__(self, g: FlatGraph, aux: Optional[EngineAux] = None):
        self.g = g
        self.aux = engine_aux(g) if aux is None else aux
        self._setup(g.n, int(g.m), g.edge_capacity, g.device, self.aux.degrees)

    def _setup(self, n: int, m: int, cap: int, device: torch.device, degrees) -> None:
        self._n = n
        self._m = m
        self.device = device
        self.ops = TorchOps(device)
        self._degrees = degrees
        self._wdeg = None  # lazy weighted out-degree cache
        # static sparse budgets: a frontier routed sparse obeys
        # |U| + deg(U) <= m/20 <= cap/20.  Forced-sparse mode needs full
        # budgets.
        self._auto_ids_budget = min(n, _round_up(cap // DENSE_THRESHOLD_DENOM + 1, 64))
        self._auto_edge_budget = min(cap, _round_up(cap // DENSE_THRESHOLD_DENOM + 1, 64))
        self._full_ids_budget = n
        self._full_edge_budget = max(cap, 1)

    def _views(self) -> Tuple[FlatGraph, EngineAux]:
        """The raw pool and aux every query reads (``CompressedEngine``
        decodes them per query)."""
        return self.g, self.aux

    # -- graph shape --------------------------------------------------------
    @property
    def n(self) -> int:
        return self._n

    @property
    def m(self) -> int:
        return self._m

    @property
    def degrees(self) -> torch.Tensor:
        return self._degrees

    @property
    def weights(self) -> Optional[torch.Tensor]:
        """The pool-parallel per-edge value array (float32[cap]), or None."""
        return self.g.weights

    @property
    def weighted_degrees(self) -> torch.Tensor:
        """Sum of out-edge weights per vertex: a true segment sum over the
        src-major pool on the kernel (cached per engine)."""
        if self.weights is None:
            return self._degrees.float()
        if self._wdeg is None:
            g, a = self._views()
            msg = torch.where(a.evalid, g.weights, 0)
            self._wdeg = _segsum_rows_float(msg[None, :], _src_key(g), self._n)[0]
        return self._wdeg

    @property
    def resident_nbytes(self) -> int:
        """Device bytes held per snapshot: raw pool + ``EngineAux``."""
        leaves = [*self.g, *self.aux]
        return sum(t.numel() * t.element_size() for t in leaves if torch.is_tensor(t))

    # -- frontiers ----------------------------------------------------------
    def _subset(self, dense: torch.Tensor) -> TorchVertexSubset:
        return TorchVertexSubset(dense, self._degrees)

    def frontier_from_ids(self, ids) -> TorchVertexSubset:
        mask = torch.zeros(self._n, dtype=torch.bool, device=self.device)
        mask[_lanes(ids, self.device)] = True
        return self._subset(mask)

    def frontier_from_dense(self, mask) -> TorchVertexSubset:
        return self._subset(self.ops.xp.asarray(mask, dtype=torch.bool))

    def _budgets(self, mode: str) -> Tuple[int, int]:
        if mode == "sparse":
            return self._full_ids_budget, self._full_edge_budget
        return self._auto_ids_budget, self._auto_edge_budget

    # -- edgeMap ------------------------------------------------------------
    def edge_map(
        self,
        U: TorchVertexSubset,
        F: Callable,
        C: Callable,
        state,
        direction_optimize: bool = True,
        mode: str = "auto",
    ) -> Tuple[TorchVertexSubset, object]:
        if mode == "auto" and not direction_optimize:
            mode = "sparse"
        if mode == "auto":
            size, deg = U.stats()
            mode = "dense" if size + deg > max(1, self._m // DENSE_THRESHOLD_DENOM) else "sparse"
        ops = self.ops
        g, a = self._views()
        cmask = C(ops, state, torch.arange(self._n, dtype=torch.int32, device=self.device))
        if mode == "dense":
            valid = a.evalid & U.dense[a.src_c.long()] & cmask[a.dst_c.long()]
            state, out = F(ops, state, a.src_c, a.dst_c, g.weights, valid)
        else:
            ids_b, edge_b = self._budgets(mode)
            us, vs, ev, eidx = _sparse_expand(
                g.offsets, g.keys, U.dense[None, :], self._n, ids_b, edge_b
            )
            us, vs, ev, eidx = us[0], vs[0], ev[0], eidx[0]
            ws = None if g.weights is None else g.weights[eidx]
            state, out = F(ops, state, us, vs, ws, ev & cmask[vs.long()])
        return self._subset(out), state

    # -- batched traversals -------------------------------------------------
    def bfs_batch(self, sources) -> Tuple[torch.Tensor, torch.Tensor]:
        """(parents, depths) int32[B, n] (see module-level ``bfs_batch``)."""
        return bfs_batch(*self._views(), sources, ids_budget=self._auto_ids_budget,
                         edge_budget=self._auto_edge_budget)

    def bc_batch(self, sources) -> torch.Tensor:
        """Dependency scores float[B, n] (see module-level ``bc_batch``)."""
        return bc_batch(*self._views(), sources)

    def sssp_batch(self, sources) -> torch.Tensor:
        """Shortest-path distances float[B, n] (+inf = unreached)."""
        return sssp_batch(*self._views(), sources, ids_budget=self._auto_ids_budget,
                          edge_budget=self._auto_edge_budget)

    def sssp_batch_from(self, dist0, frontier0, unit: bool = False) -> torch.Tensor:
        """Warm-start (min, +) relaxation from arbitrary initial state."""
        return sssp_batch_from(*self._views(), dist0, frontier0,
                               ids_budget=self._auto_ids_budget,
                               edge_budget=self._auto_edge_budget, unit=unit)

    def parents_from_depths(self, depths) -> torch.Tensor:
        """BFS parents from depth rows (the max-contention rule of ``bfs_batch``)."""
        return _parents_pass(*self._views(), np.asarray(depths, np.int32))

    def cc_labels(self) -> torch.Tensor:
        """Whole-graph min-label CC to fixpoint over the prebuilt aux."""
        g, a = self._views()
        return cc_labels(g, aux=a)

    # -- dense semiring reduce (segment-sum kernels) ------------------------
    def edge_map_reduce(self, values: torch.Tensor) -> torch.Tensor:
        """out[v] = sum_{u->v} w(u,v) * values[u] on the kernel (the
        weighted kernel on weighted graphs)."""
        a = self.aux
        msg = _reduce_msgs(values, a.src_by_dst, a.valid_by_dst)[:, None]
        if a.w_by_dst is None:
            out = kops.segment_sum(a.dst_sorted, msg, self._n)
        else:
            out = kops.segment_sum_weighted(a.dst_sorted, a.w_by_dst, msg, self._n)
        return out[:, 0].to(values.dtype)

    def edge_map_reduce_batch(self, values: torch.Tensor) -> torch.Tensor:
        """(B, n) value rows through ONE kernel call: the message columns
        carry the B query lanes."""
        a = self.aux
        msg = _reduce_msgs_batch(values, a.src_by_dst, a.valid_by_dst)
        if a.w_by_dst is None:
            out = kops.segment_sum(a.dst_sorted, msg, self._n)
        else:
            out = kops.segment_sum_weighted(a.dst_sorted, a.w_by_dst, msg, self._n)
        return out.T.to(values.dtype)

    # -- vertexMap ----------------------------------------------------------
    def vertex_map(self, U: TorchVertexSubset, P: Callable, state) -> TorchVertexSubset:
        keep = P(self.ops, state, torch.arange(self._n, dtype=torch.int32, device=self.device))
        return self._subset(U.dense & keep)

    def to_host(self, x) -> np.ndarray:
        HOST_SYNCS.bump()
        return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# whole-graph traversals over a prebuilt (or derived) aux
# ---------------------------------------------------------------------------


def _endpoints(g: FlatGraph, aux: Optional[EngineAux]):
    if aux is not None:
        return aux.src_c, aux.dst_c, aux.evalid
    return _pool_endpoints(g)


def dense_expand(g: FlatGraph, frontier: torch.Tensor, aux: Optional[EngineAux] = None):
    """One dense edgeMap expansion: bool[n] frontier -> bool[n] reached."""
    src_c, dst_c, evalid = _endpoints(g, aux)
    n = g.n
    msg = frontier[src_c.long()] & evalid
    out = msg.new_zeros(n + 1)
    out[torch.where(msg, dst_c.long(), n)] = True
    return out[:n]


def bfs_levels(g: FlatGraph, source: int, aux: Optional[EngineAux] = None) -> torch.Tensor:
    """Full BFS levels by dense rounds (one sync per round)."""
    n = g.n
    levels = torch.full((n,), -1, dtype=torch.int32, device=g.device)
    levels[source] = 0
    frontier = torch.zeros(n, dtype=torch.bool, device=g.device)
    frontier[source] = True
    d = 0
    while _sync(frontier.any())[0]:
        frontier = dense_expand(g, frontier, aux) & (levels < 0)
        levels = torch.where(frontier, d + 1, levels)
        d += 1
    return levels


def cc_labels(g: FlatGraph, aux: Optional[EngineAux] = None) -> torch.Tensor:
    """Min-label propagation to fixpoint (one sync per round)."""
    src_c, dst_c, evalid = _endpoints(g, aux)
    labels = torch.arange(g.n, dtype=torch.int32, device=g.device)
    src, dst = src_c.long(), dst_c.long()
    while True:
        msg = torch.where(evalid, labels[src], torch.iinfo(torch.int32).max)
        new = labels.clone().scatter_reduce_(0, dst, msg, "amin", include_self=True)
        changed = (new != labels).any()
        labels = new
        if not _sync(changed)[0]:
            return labels


# ---------------------------------------------------------------------------
# compressed engine: queries served from a chunk-compressed resident pool
# ---------------------------------------------------------------------------


class CompressedAux(NamedTuple):
    """Per-snapshot derived state for ``CompressedEngine``: ``EngineAux``
    with its two O(cap) int lanes chunk-compressed (``dst_sorted`` is
    ascending, ``src_by_dst`` ascending within each dst segment).  The
    O(n) arrays and the float value lane stay raw; ``valid_by_dst``
    collapses to ``m_valid``, since valid slots are the sorted prefix."""

    dst_sorted_c: cz.ChunkedStream  # destinations ascending (pad = n)
    srcbd_c: cz.ChunkedStream  # sources permuted dst-major
    dst_offsets: torch.Tensor  # int32[n+1] segment bounds into dst_sorted
    degrees: torch.Tensor  # int32[n]
    m_valid: torch.Tensor  # int32 0-dim: count of valid pool slots
    w_by_dst: Optional[torch.Tensor] = None  # float32[capC] values dst-major


def compressed_aux_from_state(dst_sorted_c, srcbd_c, dst_offsets, degrees, m_valid,
                              w_by_dst=None, device=None) -> CompressedAux:
    """The port's CompressedAux from the reference's leaves as numpy
    arrays (each stream as its leaves in ``ChunkedStream`` order)."""
    from ..._device import resolve

    dev = resolve(device)
    return CompressedAux(
        cz.from_state(*dst_sorted_c, device=dev),
        cz.from_state(*srcbd_c, device=dev),
        torch.from_numpy(np.array(dst_offsets, np.int32)).to(dev),
        torch.from_numpy(np.array(degrees, np.int32)).to(dev),
        torch.tensor(int(m_valid), dtype=torch.int32, device=dev),
        None if w_by_dst is None else torch.from_numpy(np.array(w_by_dst, np.float32)).to(dev),
    )


def engine_aux_compressed(cg: CompressedPool, aux_hi_cap: Optional[int] = None) -> CompressedAux:
    """Decompress, build ``engine_aux``, re-compress the two int lanes with
    the pool stream's width and escape capacity.  An adaptive pool gets
    adaptive aux lanes with the pool's hi capacity unless ``aux_hi_cap``
    overrides it (the engine retries at full capacity when only the aux
    lanes overflow)."""
    aux = engine_aux(decompress(cg))
    k = cg.dst.k
    if cg.dst.adaptive:
        hi_cap = cg.dst.hi_cap if aux_hi_cap is None else aux_hi_cap
        dst_sorted_c = cz.encode_stream_adaptive(aux.dst_sorted, hi_cap=hi_cap, k=k)
        srcbd_c = cz.encode_stream_adaptive(aux.src_by_dst, hi_cap=hi_cap, k=k)
    else:
        dst_sorted_c = cz.encode_stream(aux.dst_sorted, width=cg.dst.width, k=k)
        srcbd_c = cz.encode_stream(aux.src_by_dst, width=cg.dst.width, k=k)
    w = aux.w_by_dst
    if w is not None and dst_sorted_c.length > w.shape[0]:
        w = torch.cat([w, w.new_zeros(dst_sorted_c.length - w.shape[0])])
    return CompressedAux(
        dst_sorted_c=dst_sorted_c,
        srcbd_c=srcbd_c,
        dst_offsets=aux.dst_offsets,
        degrees=aux.degrees,
        m_valid=aux.evalid.sum().to(torch.int32),
        w_by_dst=w,
    )


def _inflate(cg: CompressedPool, caux: CompressedAux) -> Tuple[FlatGraph, EngineAux]:
    """(CompressedPool, CompressedAux) -> (FlatGraph, EngineAux): the raw
    views every query reads, decoded per query and dropped after it."""
    g = decompress(cg)
    cap = g.edge_capacity
    src_c, dst_c, evalid = _pool_endpoints(g)
    return g, EngineAux(
        src_c=src_c,
        dst_c=dst_c,
        evalid=evalid,
        degrees=caux.degrees,
        dst_sorted=cz.decode_stream(caux.dst_sorted_c, cap),
        src_by_dst=cz.decode_stream(caux.srcbd_c, cap),
        valid_by_dst=torch.arange(cap, device=g.device) < caux.m_valid,
        dst_offsets=caux.dst_offsets,
        w_by_dst=None if caux.w_by_dst is None else caux.w_by_dst[:cap],
    )


def _edge_map_reduce_compressed(caux: CompressedAux, values_b: torch.Tensor, n: int):
    """The (+, x) reduce on compressed operands: the chunked ``dst_sorted``
    lane goes to the chunked segment-sum kernel undecoded; the src gather
    lane is decoded (a gather needs materialized indices)."""
    src_by_dst = cz.decode_stream(caux.srcbd_c)  # int32[capC]
    valid = torch.arange(src_by_dst.shape[0], device=src_by_dst.device) < caux.m_valid
    msg = _reduce_msgs_batch(values_b, src_by_dst, valid)
    s = caux.dst_sorted_c
    if caux.w_by_dst is None:
        return kops.segment_sum_chunked(s.anchors, s.deltas, s.ovf_pos, s.ovf_add, msg, n,
                                        hi=s.hi, wide=s.wide)
    return kops.segment_sum_weighted_chunked(s.anchors, s.deltas, s.ovf_pos, s.ovf_add,
                                             caux.w_by_dst, msg, n, hi=s.hi, wide=s.wide)


def _any_spilled(*streams: cz.ChunkedStream) -> bool:
    return bool(torch.stack([s.spill for s in streams]).any())


class CompressedEngine(TorchEngine):
    """``TorchEngine`` served from a chunk-compressed resident snapshot.

    Holds a ``CompressedPool`` + ``CompressedAux`` instead of the raw pool
    + ``EngineAux``: every query decodes the raw views it reads
    (``_inflate``), and ``edge_map_reduce`` runs the chunked segment-sum
    kernels, which decode inside the kernel.  The method surface, budgets
    and frontier helpers are inherited.
    """

    def __init__(self, cg: CompressedPool, aux: Optional[CompressedAux] = None):
        self.cg = cg
        self.caux = engine_aux_compressed(cg) if aux is None else aux
        # One read of the flags at construction: a spilled pool or aux lane
        # would mis-decode every query.
        pool_spilled = _any_spilled(cg.dst)
        aux_spilled = _any_spilled(self.caux.dst_sorted_c, self.caux.srcbd_c)
        if not pool_spilled and aux_spilled and aux is None and cg.dst.adaptive:
            # The adaptive aux lanes inherited the pool's exact-fit hi
            # capacity but need more wide chunks than the pool did: retry
            # once at full capacity before declaring an escape-lane spill.
            self.caux = engine_aux_compressed(cg, aux_hi_cap=cg.dst.deltas.shape[0])
            aux_spilled = _any_spilled(self.caux.dst_sorted_c, self.caux.srcbd_c)
        if pool_spilled or aux_spilled:
            raise ValueError(
                "compressed stream spilled its escape lane; rebuild the "
                "snapshot with a wider delta lane or keep the raw engine"
            )
        self._setup(cg.n, int(cg.m), cg.edge_capacity, cg.device, self.caux.degrees)

    def _views(self) -> Tuple[FlatGraph, EngineAux]:
        return _inflate(self.cg, self.caux)

    @property
    def weights(self) -> Optional[torch.Tensor]:
        return self.cg.weights

    @property
    def resident_nbytes(self) -> int:
        """Device bytes held per snapshot: compressed pool + compressed aux."""
        return cz.pytree_nbytes(self.cg) + cz.pytree_nbytes(self.caux)

    def edge_map_reduce(self, values: torch.Tensor) -> torch.Tensor:
        out = _edge_map_reduce_compressed(self.caux, values[None, :], self._n)
        return out[:, 0].to(values.dtype)

    def edge_map_reduce_batch(self, values: torch.Tensor) -> torch.Tensor:
        return _edge_map_reduce_compressed(self.caux, values, self._n).T.to(values.dtype)
