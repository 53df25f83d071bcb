"""Sharded traversal backend over the range-sharded pool (DESIGN.md §9).

Counterpart of ``repro/core/traversal/sharded_backend.py`` (lines
1-1498).  The same algorithm text that runs on ``NumpyEngine`` and
``TorchEngine`` runs here over ``sharded_pool.ShardedGraph``: edge data
never leaves its shard row, and the only cross-shard traffic of an
edgeMap round is vertex-state sized (O(n) words, never O(pool) edges).

The reference runs each step as an explicit ``shard_map`` over a device
mesh.  The port runs it on ranks (``sharded_pool.PoolMesh``): each rank
holds a block of ``S / k`` shard rows, each row's partial result laid out
along a leading ``[S/k, ...]`` axis, and ``ShardedOps``' collectives
(``psum``, ``pmax``, ``pmin``, ``psum_scatter``, ``all_gather``) reduce
over that axis first, then across the ranks with ``torch.distributed``
(``all_reduce``, ``reduce_scatter_tensor``, ``all_gather_into_tensor``).
One rank with no process group holds every row and stops at the local
reduction (the one-device form the reference's tier-1 tests use).  They
are the only cross-shard points of the port, and each logs the bytes of
the operand each rank sends (``collective_log``), which stands in for
the reference's jaxpr walker ``collective_operand_bytes``.  Ranks run as
processes of one ``torch.distributed`` group (``launch.mesh.init_ranks``:
NCCL on the card, gloo on the host, where gloo has no CUDA form of a
collective it goes through host memory, ``HOST_COPIED``); ROADMAP.md
item 16's first half.

How arbitrary F/C callbacks stay correct across shards: every state
write of an F callback goes through the masked ``ops.scatter_*``
helpers.  Each edge lane carries its shard id (``ShardedOps.with_lanes``),
so each helper scatters into per-shard partials and merges them with one
collective::

  scatter_add  ->  target + psum(local deltas)
  scatter_max  ->  max(target, pmax(local candidates))
  scatter_min  ->  min(target, pmin(local candidates))
  scatter_or   ->  target | pmax(local hits)

add/max/min/or are commutative and associative, so the merged result is
one global scatter over the union of the shards' edges (each edge lives
in exactly one shard).  The Beamer rule reads the frontier degrees
psum'd once per version (``ShardAux.deg_total``).

The sparse (push) expansion walks the frontier's adjacency in key order
across the shard rows: vertex v's out-edges are the keys of every shard
below ``v + 1 << 32`` and at or above ``v << 32``, and their global rank
is ``sum_s offsets[s, v]`` (psum'd once per version), so one
fixed-budget expansion visits each shard's own slots and tags each lane
with its shard.

Float reduces run on the hand kernels, not the reference's cumsum
difference (which cancels past 2^24): the (+, x) reduce of PageRank, the
weighted degrees and the BC rounds go through ``kops.segment_sum`` /
``segment_sum_weighted`` (rows 1-2) on the raw pool and the chunked
segment sums (rows 3-6) on the compressed one, one launch per shard row
over its live lanes only, keyed relative to the row's own key range (a
shard's sources are one contiguous range, and on community graphs so
are its destinations); ``psum_scatter`` merges the per-shard partials.
One launch over all rows under shard-offset keys ``s * (n + 1) + v``
would make each row's pad lanes one long run and the keys outside a
shard's range one long gap, which the kernels' fix-up sums and zeroes
on one thread each (PERF.md §6).
Integer reductions (the BFS pull) keep the exact prefix-sum difference.

Host syncs: one per round, as ``TorchEngine`` (``base.py``).
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...kernels import ops as kops
from .. import compressed as cz
from ..sharded_pool import (
    CompressedShardedGraph,
    CompressedShardedPool,
    PoolMesh,
    ShardAux,
    ShardedGraph,
    ShardedPool,
    _row_endpoints,
    decompress_pool,
    graph_num_edges,
    pool_mesh,
    shard_aux,
)
from .base import DENSE_THRESHOLD_DENOM, HOST_SYNCS, TraversalEngine
from .torch_backend import (
    TorchOps,
    TorchVertexSubset,
    _lanes,
    _round_up,
    _sync,
    _use_dense,
)

AXIS = "shard"

_LOG_LOCK = threading.Lock()
_LOGS: List[list] = []
# collectives that went through host memory: gloo has no CUDA form of them
HOST_COPIED: set = set()


@contextmanager
def collective_log():
    """Record ``(collective, per-shard operand bytes)`` for every
    collective issued while the block runs (all threads): the port's
    counterpart of the reference's ``collective_operand_bytes``, read by
    the tests that pin the O(frontier + batch), never O(pool), wire
    contract."""
    log: list = []
    with _LOG_LOCK:
        _LOGS.append(log)
    try:
        yield log
    finally:
        with _LOG_LOCK:
            _LOGS.remove(log)


def _neutral(dtype, how: str):
    """Identity of amax (``how="amax"``) or amin over ``dtype``."""
    if dtype == torch.bool:
        return how != "amax"
    if dtype.is_floating_point:
        return -math.inf if how == "amax" else math.inf
    info = torch.iinfo(dtype)
    return info.min if how == "amax" else info.max


# the collectives gloo runs on CUDA tensors; the rest go through host memory
_GLOO_CUDA = ("all_reduce",)


def _dist_call(name: str, fn, out: torch.Tensor, inp: torch.Tensor) -> torch.Tensor:
    """``fn(out, inp)``, a ``torch.distributed`` collective, on the
    tensors' device; under gloo, which has a CUDA form of its all-reduce
    only (and not for every dtype), a CUDA gather or reduce-scatter, or
    an all-reduce it refuses, goes through host copies (recorded in
    ``HOST_COPIED``).  Every rank runs the same call on the
    same dtype and device, so all take the same route."""
    import warnings

    import torch.distributed as dist

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)  # *_into_tensor / *_tensor names
        if not inp.is_cuda or dist.get_backend() != "gloo":
            fn(out, inp)
            return out
        if name.startswith(_GLOO_CUDA) and name not in HOST_COPIED:
            try:
                fn(out, inp)
                return out
            except RuntimeError:  # a dtype its CUDA all-reduce lacks: every rank alike
                pass
        HOST_COPIED.add(name)
        h_out = out.cpu()
        fn(h_out, inp.cpu())
        return out.copy_(h_out)


def _all_reduce(t: torch.Tensor, how: str) -> torch.Tensor:
    """``t`` all-reduced across the ranks (``how``: sum, max or min); a
    boolean goes as ``uint8`` (max is or, min is and)."""
    import torch.distributed as dist

    op = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}[how]
    x = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()  # a fresh reduction
    x = _dist_call(f"all_reduce_{how}", lambda o, i: dist.all_reduce(o, op=op), x, x)
    return x.bool() if t.dtype == torch.bool else x


def _padded(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x`` with its first dim padded with zeros to a multiple of ``k``."""
    pad = -x.shape[0] % k
    return x if not pad else torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


class ShardedOps(TorchOps):
    """``TorchOps`` whose scatter helpers merge across the shard axis, and
    the port's only collective points.

    A collective takes this rank's rows' partials stacked on a leading
    ``[S/k, ...]`` axis and returns the merged value every shard then
    holds: a reduction over the local rows, then one ``torch.distributed``
    collective across the ranks (none on one rank).  The scatter helpers
    need each edge lane's shard: an engine binds it with ``with_lanes``
    before calling F (an int L: lane ``i`` is in local row ``i // L``; or
    a tensor of local row ids)."""

    def __init__(self, mesh: PoolMesh, n_shards: int = 1, lanes=None):
        super().__init__(mesh.device)
        self.mesh = mesh
        self.n_shards = n_shards
        self._lanes = lanes

    def with_lanes(self, lanes) -> "ShardedOps":
        return ShardedOps(self.mesh, self.n_shards, lanes)

    # -- collectives over the shard axis -------------------------------------
    @staticmethod
    def _log(name: str, part: torch.Tensor) -> None:
        nbytes = part.numel() * part.element_size()
        with _LOG_LOCK:
            for log in _LOGS:
                log.append((name, nbytes))

    @property
    def _ranks(self) -> bool:
        return self.mesh.distributed

    def psum(self, parts: torch.Tensor) -> torch.Tensor:
        self._log("psum", parts[0])
        local = parts.sum(0, dtype=parts.dtype) if parts.dtype != torch.bool else parts.any(0)
        return _all_reduce(local, "sum" if parts.dtype != torch.bool else "max") \
            if self._ranks else local

    def pmax(self, parts: torch.Tensor) -> torch.Tensor:
        self._log("pmax", parts[0])
        local = parts.any(0) if parts.dtype == torch.bool else parts.amax(0)
        return _all_reduce(local, "max") if self._ranks else local

    def pmin(self, parts: torch.Tensor) -> torch.Tensor:
        self._log("pmin", parts[0])
        local = parts.all(0) if parts.dtype == torch.bool else parts.amin(0)
        return _all_reduce(local, "min") if self._ranks else local

    def psum_scatter(self, parts: torch.Tensor) -> torch.Tensor:
        """Sum over shards: a ``reduce_scatter_tensor`` of the local sum
        on the vertex axis (padded to a multiple of the rank count), each
        rank keeping its chunk, then the chunks' ``all_gather_into_tensor``
        (the reference's ``P('shard')`` result, gathered where it is
        read).  One rank keeps every chunk."""
        import torch.distributed as dist

        self._log("psum_scatter", parts[0])
        local = parts.sum(0, dtype=parts.dtype)
        if not self._ranks:
            return local
        k, n = self.mesh.size, local.shape[0]
        full = _padded(local, k).contiguous()
        chunk = full.new_empty((full.shape[0] // k,) + tuple(full.shape[1:]))
        chunk = _dist_call("reduce_scatter_tensor", dist.reduce_scatter_tensor, chunk, full)
        return _dist_call("all_gather_into_tensor", dist.all_gather_into_tensor,
                          torch.empty_like(full), chunk)[:n]

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every shard receives ``x`` (the update step's batch): each rank
        sends its 1/k of it and ``all_gather_into_tensor`` puts the whole
        together on every rank."""
        import torch.distributed as dist

        self._log("all_gather", x)
        if not self._ranks:
            return x
        k, r, n = self.mesh.size, self.mesh.rank, x.shape[0]
        full = _padded(x, k)
        c = full.shape[0] // k
        return _dist_call("all_gather_into_tensor", dist.all_gather_into_tensor,
                          torch.empty_like(full), full[r * c:(r + 1) * c].contiguous())[:n]

    def gather_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """All ranks' rows ``[S/k, ...]`` as ``[S, ...]`` on every rank
        (O(pool): the rebalance's compaction and the checks only)."""
        import torch.distributed as dist

        self._log("gather_rows", rows)
        if not self._ranks:
            return rows
        x = rows.contiguous()
        out = x.new_empty((x.shape[0] * self.mesh.size,) + tuple(x.shape[1:]))
        return _dist_call("all_gather_into_tensor", dist.all_gather_into_tensor, out, x)

    def same_on_every_rank(self, h: int) -> bool:
        """Whether every rank passed the same int ``h`` (< 2^40): one
        scalar all-reduce SUM, each rank checking it is k times its own."""
        self._log("policy_check", torch.zeros((), dtype=torch.int64))
        if not self._ranks:
            return True
        total = _all_reduce(torch.tensor(h, dtype=torch.int64, device=self.device), "sum")
        return int(total) == self.mesh.size * h

    # -- masked scatters, merged by one collective each ----------------------
    def _positions(self, idx: torch.Tensor, mask: torch.Tensor, n: int) -> torch.Tensor:
        """Each lane's slot ``shard * n + v`` in the [S, n] partials.  A
        masked lane goes to ``lane % n`` of its shard instead and carries
        the reduction's identity: spread that way, masked and pad lanes
        (a pool's pads all clip to vertex 0) never pile their atomics on
        one slot."""
        lane = torch.arange(idx.numel(), device=idx.device).reshape(idx.shape)
        if torch.is_tensor(self._lanes):
            shard = self._lanes.reshape(idx.shape).long()
        else:
            shard = lane // int(self._lanes)
        return shard * n + torch.where(mask, idx.long(), lane % n)

    def _partials(self, target, idx, vals, mask, fill, how):
        """The shards' local scatters as [S, n] partials; ``fill`` is the
        identity of ``how``."""
        S, n = self.n_shards, target.shape[0]
        pos = self._positions(idx, mask, n).reshape(-1)
        src = torch.as_tensor(vals, dtype=target.dtype, device=target.device)
        src = torch.where(mask, src, torch.full((), fill, dtype=target.dtype,
                                                device=target.device)).reshape(-1)
        local = torch.full((S * n,), fill, dtype=target.dtype, device=target.device)
        if how == "sum":
            local.index_add_(0, pos, src)
        else:
            local.scatter_reduce_(0, pos, src, how, include_self=True)
        return local.view(S, n)

    def scatter_max(self, target, idx, vals, mask):
        local = self._partials(target, idx, vals, mask, _neutral(target.dtype, "amax"), "amax")
        return torch.maximum(target, self.pmax(local))

    def scatter_min(self, target, idx, vals, mask):
        local = self._partials(target, idx, vals, mask, _neutral(target.dtype, "amin"), "amin")
        return torch.minimum(target, self.pmin(local))

    def scatter_add(self, target, idx, vals, mask):
        return target + self.psum(self._partials(target, idx, vals, mask, 0, "sum"))

    def scatter_or(self, target, idx, mask):
        S, n = self.n_shards, target.shape[0]
        local = torch.zeros(S * n + 1, dtype=torch.bool, device=target.device)
        # plain stores of True, so the masked lanes' sink slot is no hot spot
        local[torch.where(mask, self._positions(idx, mask, n), S * n)] = True
        return target | self.pmax(local[:-1].view(S, n))


# ---------------------------------------------------------------------------
# pool-level helpers (each row's work touches only that row)
# ---------------------------------------------------------------------------


def _src_key(p: ShardedPool, n: int, W: int) -> torch.Tensor:
    """int32[S, W]: each row's src per slot of its first W (ascending: the
    row is sorted) and n on pad slots: the src-major segment key."""
    slot = torch.arange(W, device=p.device)[None, :]
    return torch.where(slot < p.n[:, None], p.data[:, :W] >> 32, n).to(torch.int32)


def _src_vals(p: ShardedPool, W: int) -> Optional[torch.Tensor]:
    """The value lane of each row's first W slots, flattened (None when
    unweighted)."""
    return None if p.vals is None else p.vals[:, :W].reshape(-1)


_LANES = ("src_c", "dst_c", "evalid", "dst_sorted", "src_by_dst", "valid_by_dst", "w_by_dst")


def _trim(aux: ShardAux, W: int) -> ShardAux:
    """``aux`` with its per-slot lanes cut to each row's first W slots: no
    row holds more than W live slots (every live slot of a row is in its
    first n_s, src- and dst-major alike), so the queries' dense passes
    skip the pool's slack."""
    if aux.src_c.shape[1] <= W:
        return aux
    return aux._replace(**{k: getattr(aux, k)[:, :W].contiguous() for k in _LANES
                           if getattr(aux, k) is not None})


def _seg_partials(msg_b, seg, S: int, n: int, fill, how: str) -> torch.Tensor:
    """(B, E) lane messages -> (S, B, n) per-shard segment max/min, keyed
    by ``seg`` (``s * n + v``); ``fill`` is the identity of ``how``, and a
    lane that must not count carries it."""
    B = msg_b.shape[0]
    out = torch.full((B, S * n), fill, dtype=msg_b.dtype, device=msg_b.device)
    idx = seg.expand(B, -1) if seg.dim() == 1 else seg
    out.scatter_reduce_(1, idx, msg_b, how, include_self=True)
    return out.view(B, S, n).transpose(0, 1)


def _dst_seg(a: ShardAux, n: int) -> torch.Tensor:
    """int64[S * cap]: ``s * n + dst`` of each dst-major slot; a pad slot
    gets ``s * n + slot % n``, spread so its (identity) message never
    meets the other pads' on one slot."""
    S, cap = a.dst_sorted.shape
    slot = torch.arange(S * cap, device=a.dst_sorted.device)
    d = a.dst_sorted.reshape(-1).long()
    return (slot // cap) * n + torch.where(d < n, d, slot % n)


def _row_ranges(offs: torch.Tensor):
    """From per-row CSR bounds int[S, n+1] over a row's ascending key lane:
    (live lanes, first key, last key) of each row, each int64[S]; a row
    with no lanes gets the empty range (n, n - 1)."""
    n = offs.shape[1] - 1
    total = offs[:, -1:]
    return (total[:, 0].long(), (offs == 0).sum(1) - 1, n - (offs == total).sum(1))


def _sparse_expand(goff, cum_n, keys, U_b, n: int, ids_budget: int, edge_budget: int):
    """Fixed-budget push expansion of a (B, n) frontier batch across the
    shard rows: (us, vs, ev, slot, shard), each (B, edge_budget).
    ``goff`` (int64[n+1]) is each vertex's global edge rank, ``cum_n``
    (int64[S+1]) the exclusive prefix of the shards' counts; a global
    edge rank maps to its shard and its slot ``s * cap + local`` of the
    flattened [S, cap] pool.  ``ev`` masks the padded tail and edges
    naming nonexistent destinations."""
    dev = U_b.device
    B = U_b.shape[0]
    S, cap = keys.shape
    pos = torch.cumsum(U_b, 1) - 1
    slot = torch.where(U_b & (pos < ids_budget), pos, ids_budget)
    ids_raw = torch.full((B, ids_budget + 1), n, dtype=torch.int64, device=dev)
    ids_raw.scatter_(1, slot, torch.arange(n, device=dev).expand(B, n))
    ids_raw = ids_raw[:, :ids_budget]
    vid = ids_raw < n
    ids = torch.where(vid, ids_raw, 0)
    starts = goff[ids]
    degs = torch.where(vid, goff[ids + 1] - starts, 0)
    cum = torch.cumsum(degs, 1)
    j = torch.arange(edge_budget, device=dev).expand(B, edge_budget).contiguous()
    seg = torch.searchsorted(cum, j, right=True).clamp_(0, ids_budget - 1)
    prev = torch.where(seg > 0, cum.gather(1, (seg - 1).clamp_(min=0)), 0)
    erank = starts.gather(1, seg) + (j - prev)
    ev = j < cum[:, -1:]
    erank = torch.where(ev, erank, 0)
    shard = (torch.searchsorted(cum_n[1:].contiguous(), erank, right=True)).clamp_(max=S - 1)
    pslot = shard * cap + (erank - cum_n[shard])
    pslot = torch.where(ev, pslot, 0)
    vs_raw = keys.reshape(-1)[pslot] & 0xFFFFFFFF  # int64: no wraparound
    ev = ev & (vs_raw < n)
    vs = vs_raw.clamp(0, n - 1).to(torch.int32)
    us = ids.gather(1, seg).to(torch.int32)
    return us, vs, ev, pslot, shard


class _Views(NamedTuple):
    """What one query reads: the raw pool and its aux
    (``CompressedShardedEngine`` decodes both per query)."""

    pool: ShardedPool
    aux: ShardAux


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


class ShardedEngine(TraversalEngine):
    """Engine over an (immutable) ``ShardedGraph``, on its device.

    The full backend contract of ``base.py`` — BFS / CC / PageRank / SSSP
    / BC in ``algorithms.py`` run unchanged — plus the batched drivers
    ``bfs_batch`` / ``bc_batch`` / ``sssp_batch`` / ``sssp_batch_from`` /
    ``parents_from_depths``.  ``aux`` may be passed in pre-built by a
    version-pinned caller."""

    def __init__(self, sg: ShardedGraph, aux: Optional[ShardAux] = None,
                 mesh: Optional[PoolMesh] = None):
        self.sg = sg
        self.mesh = pool_mesh(sg.n_shards, sg.device) if mesh is None else mesh
        self._check_mesh(sg.n_shards)
        self.ops = ShardedOps(self.mesh, sg.pool.rows)
        aux = shard_aux(sg.pool, sg.n, self.ops) if aux is None else aux
        self._setup(sg.n, graph_num_edges(sg, self.mesh), sg.n_shards, sg.pool.cap_per,
                    sg.pool, aux.offsets, aux.dst_offsets)
        self.aux = _trim(aux, self._width)

    def _check_mesh(self, n_shards: int) -> None:
        if n_shards % self.mesh.shape[AXIS] != 0:
            raise ValueError(f"n_shards={n_shards} must be a multiple of the mesh "
                             f"size {self.mesh.shape[AXIS]}")

    def _setup(self, n, m, S, cap, pool, offsets, dst_offsets) -> None:
        """``S`` is the global shard count; ``self._S`` this rank's rows."""
        self._n, self._m, self._S, self._cap = n, m, offsets.shape[0], cap
        self._S_total = S
        # each row's live lanes and key range, src-major and dst-major (one
        # host read per version): the per-shard launches skip pad lanes and
        # the empty rows outside a shard's range
        plan = torch.stack([*_row_ranges(offsets), *_row_ranges(dst_offsets)]).tolist()
        self._rows = {"src": list(zip(*plan[:3])), "dst": list(zip(*plan[3:]))}
        # the dense passes' lane width: the fullest row's count, in whole
        # chunks (a compressed row decodes by the chunk)
        self._width = min(cap, max(1, -(-max(plan[0]) // cz.CHUNK)) * cz.CHUNK)
        self.device = pool.device
        self._wdeg = None  # lazy weighted out-degree cache
        # the expansion's edge ranks over this rank's rows: each rank
        # expands the frontier's out-edges it holds, and the scatters'
        # collectives merge the ranks' lanes
        self._goff = offsets.long().sum(0)
        self._cum_n = torch.cat([pool.n.new_zeros(1), torch.cumsum(pool.n, 0)]).long()
        # static sparse budgets: a frontier routed sparse obeys
        # |U| + deg(U) <= m/20 <= S*cap/20 (all shards together, so a
        # rank's share of deg(U) fits too)
        total = S * cap
        self._auto_ids_budget = min(n, _round_up(total // DENSE_THRESHOLD_DENOM + 1, 64))
        self._auto_edge_budget = min(total, _round_up(total // DENSE_THRESHOLD_DENOM + 1, 64))
        self._full_ids_budget = n
        self._full_edge_budget = max(total, 1)

    def _views(self) -> _Views:
        return _Views(self.sg.pool, self.aux)

    # -- graph shape --------------------------------------------------------
    @property
    def n(self) -> int:
        return self._n

    @property
    def m(self) -> int:
        return self._m

    @property
    def n_shards(self) -> int:
        return self._S_total

    @property
    def degrees(self) -> torch.Tensor:
        return self.aux.deg_total

    @property
    def weights(self) -> Optional[torch.Tensor]:
        """The pool's value lane (float32[S, cap]), or None."""
        return self.sg.pool.vals

    @property
    def weighted_degrees(self) -> torch.Tensor:
        """Sum of out-edge weights per vertex: each row's src-major segment
        sum on the kernel, psum'd across shards (cached per engine)."""
        if self.weights is None:
            return self.degrees.float()
        if self._wdeg is None:
            p, a = self._views()
            W = a.src_c.shape[1]
            msg = torch.where(a.evalid.reshape(-1), _src_vals(p, W), 0)[:, None]
            self._wdeg = self.ops.psum(self._segsum(msg, _src_key(p, self._n, W), "src"))[:, 0]
        return self._wdeg

    @property
    def resident_nbytes(self) -> int:
        """Device bytes held per snapshot: the pool + ``ShardAux``."""
        return cz.pytree_nbytes(self.sg.pool) + cz.pytree_nbytes(self.aux)

    # -- frontiers ----------------------------------------------------------
    def _subset(self, dense: torch.Tensor) -> TorchVertexSubset:
        return TorchVertexSubset(dense, self.degrees)

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

    def _expand(self, p: ShardedPool, U_b, ids_budget: int, edge_budget: int):
        return _sparse_expand(self._goff, self._cum_n, p.data, U_b, self._n,
                              ids_budget, edge_budget)

    def _thresh(self) -> int:
        return max(1, self._m // DENSE_THRESHOLD_DENOM)

    # -- edgeMap ------------------------------------------------------------
    def edge_map(self, U: TorchVertexSubset, F: Callable, C: Callable, state,
                 direction_optimize: bool = True, mode: str = "auto"):
        if mode == "auto" and not direction_optimize:
            mode = "sparse"
        if mode == "auto":
            size, deg = U.stats()
            mode = "dense" if size + deg > self._thresh() else "sparse"
        p, a = self._views()
        n = self._n
        cmask = C(self.ops, state, torch.arange(n, dtype=torch.int32, device=self.device))
        if mode == "dense":
            valid = a.evalid & U.dense[a.src_c.long()] & cmask[a.dst_c.long()]
            W = a.src_c.shape[1]
            state, out = F(self.ops.with_lanes(W), state, a.src_c.reshape(-1),
                           a.dst_c.reshape(-1), _src_vals(p, W), valid.reshape(-1))
        else:
            us, vs, ev, slot, shard = self._expand(p, U.dense[None, :], *self._budgets(mode))
            ws = None if p.vals is None else p.vals.reshape(-1)[slot[0]]
            state, out = F(self.ops.with_lanes(shard[0]), state, us[0], vs[0], ws,
                           ev[0] & cmask[vs[0].long()])
        return self._subset(out), state

    # -- the float reduce on the kernels --------------------------------------
    def _segsum(self, msg: torch.Tensor, seg: torch.Tensor, order: str,
                w: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(S * cap, D) lane messages -> (S, n, D) per-shard segment sums
        on the segment-sum kernel, keyed by each row's ascending ``seg``
        (int32[S, cap], pad n; ``order`` "dst" or "src" names its row
        plan); ``w`` weights each lane.  One launch per row, over its live
        lanes and its own key range."""
        S, cap = seg.shape
        n, D = self._n, msg.shape[1]
        m3 = msg.view(S, cap, D)
        parts = msg.new_zeros((S, n, D))
        for s, (L, lo, hi) in enumerate(self._rows[order]):
            if L == 0:
                continue
            key = seg[s, :L] if lo == 0 else seg[s, :L] - lo
            if w is None:
                out = kops.segment_sum(key, m3[s, :L], hi - lo + 1)
            else:
                out = kops.segment_sum_weighted(key, w[s, :L], m3[s, :L], hi - lo + 1)
            parts[s, lo: hi + 1] = out
        return parts

    def _reduce_cols(self, values_b: torch.Tensor) -> torch.Tensor:
        """(B, n) value rows -> (n, B): out[v] = sum_{u->v} w(u, v) *
        values[u], the shards' partials merged by one psum_scatter."""
        p, a = self._views()
        sbd = a.src_by_dst.reshape(-1).long()
        msg = torch.where(a.valid_by_dst.reshape(-1)[None, :], values_b[:, sbd], 0)
        msg = msg.T.float().contiguous()
        return self.ops.psum_scatter(self._segsum(msg, a.dst_sorted, "dst", a.w_by_dst))

    def edge_map_reduce(self, values: torch.Tensor) -> torch.Tensor:
        return self._reduce_cols(values[None, :])[:, 0].to(values.dtype)

    def edge_map_reduce_batch(self, values: torch.Tensor) -> torch.Tensor:
        return self._reduce_cols(values).T.to(values.dtype)

    # -- batched traversals ---------------------------------------------------
    def _pull_reached(self, a: ShardAux, f: torch.Tensor) -> torch.Tensor:
        """The BFS pull round: per shard, the (or, and) semiring over its
        dst-major row as an exact integer prefix-sum difference, psum'd."""
        S, cap = a.src_by_dst.shape
        msg = (f[:, a.src_by_dst.reshape(-1).long()] & a.valid_by_dst.reshape(-1)[None, :])
        csum = torch.cumsum(msg.to(torch.int32), 1, dtype=torch.int32)
        padded = torch.cat([torch.zeros_like(csum[:, :1]), csum], 1)
        b = a.dst_offsets.long() + (torch.arange(S, device=f.device) * cap)[:, None]
        parts = padded[:, b[:, 1:]] - padded[:, b[:, :-1]]  # (B, S, n)
        return self.ops.psum(parts.transpose(0, 1)) > 0

    def _push_reached(self, p: ShardedPool, f: torch.Tensor, ids_b: int, edge_b: int):
        _, vs, ev, _, shard = self._expand(p, f, ids_b, edge_b)
        S, n = self._S, self._n
        local = torch.zeros((f.shape[0], S * n + 1), dtype=torch.bool, device=f.device)
        local.scatter_(1, torch.where(ev, shard * n + vs.long(), S * n), True)
        return self.ops.pmax(local[:, :-1].view(-1, S, n).transpose(0, 1))

    def bfs_batch(self, sources) -> Tuple[torch.Tensor, torch.Tensor]:
        """Multi-source direction-optimized BFS: ``(parents, depths)``
        int32[B, n], bit-identical to ``TorchEngine.bfs_batch``."""
        p, a = self._views()
        n = self._n
        src = _lanes(sources, self.device)
        B = src.shape[0]
        lane = torch.arange(B, device=self.device)
        depths = torch.full((B, n), -1, dtype=torch.int32, device=self.device)
        depths[lane, src] = 0
        f = torch.zeros((B, n), dtype=torch.bool, device=self.device)
        f[lane, src] = True
        thresh = self._thresh()
        d = 0
        while True:
            go, dense = _sync(f.any(), _use_dense(f, a.deg_total, thresh))
            if not go:
                break
            if dense:
                reached = self._pull_reached(a, f)
            else:
                reached = self._push_reached(p, f, self._auto_ids_budget, self._auto_edge_budget)
            f = reached & (depths < 0)
            depths = torch.where(f, d + 1, depths)
            d += 1
        return self._parents_pass(a, depths), depths

    def _parents_pass(self, a: ShardAux, depths: torch.Tensor) -> torch.Tensor:
        """parent(v) = max u with depth(u) = depth(v) - 1 and u->v: each
        shard's segment max over its dst-major row, pmax'd."""
        n = self._n
        depths = torch.as_tensor(depths, device=self.device).to(torch.int32)
        sbd = a.src_by_dst.reshape(-1)
        du = depths[:, sbd.long()]
        dv = depths[:, a.dst_sorted.reshape(-1).long().clamp_max(max(n - 1, 0))]
        ok = a.valid_by_dst.reshape(-1)[None, :] & (du >= 0) & (dv == du + 1)
        msg = torch.where(ok, sbd[None, :], -1)
        cand = self.ops.pmax(_seg_partials(msg, _dst_seg(a, n), self._S, n, -1, "amax"))
        vid = torch.arange(n, dtype=torch.int32, device=self.device)[None, :]
        return torch.where(depths == 0, vid, torch.where(depths > 0, cand, -1))

    def parents_from_depths(self, depths) -> torch.Tensor:
        """BFS parents from depth rows (the max-contention rule)."""
        return self._parents_pass(self._views().aux, np.asarray(depths, np.int32))

    def bc_batch(self, sources) -> torch.Tensor:
        """Multi-source Brandes dependency scores float[B, n]: each round
        the shards' (+, x) partials on the kernel, one psum per round in
        the forward pass (dst-major) and the backward pass (src-major)."""
        p, a = self._views()
        n = self._n
        src = _lanes(sources, self.device)
        B = src.shape[0]
        lane = torch.arange(B, device=self.device)
        sigma = torch.zeros((B, n), device=self.device)
        sigma[lane, src] = 1.0
        depth = torch.full((B, n), -1, dtype=torch.int32, device=self.device)
        depth[lane, src] = 0
        f = torch.zeros((B, n), dtype=torch.bool, device=self.device)
        f[lane, src] = True
        sbd = a.src_by_dst.reshape(-1).long()
        vbd = a.valid_by_dst.reshape(-1)[None, :]
        d = 0
        while _sync(f.any())[0]:
            w = torch.where(f[:, sbd] & vbd, sigma[:, sbd], 0)
            contrib = self.ops.psum(self._segsum(w.T.contiguous(), a.dst_sorted, "dst")).T
            f = (contrib > 0) & (depth < 0)
            sigma = sigma + torch.where(f, contrib, 0)
            depth = torch.where(f, d + 1, depth)
            d += 1
        src_c, dst_c = a.src_c.reshape(-1).long(), a.dst_c.reshape(-1).long()
        evalid = a.evalid.reshape(-1)[None, :]
        du, dv = depth[:, src_c], depth[:, dst_c]
        ratio = sigma[:, src_c] / torch.clamp(sigma[:, dst_c], min=1e-30)
        src_key = _src_key(p, n, a.src_c.shape[1])
        dep = torch.zeros((B, n), device=self.device)
        for dd in range(d - 2, -1, -1):
            ok = evalid & (du == dd) & (dv == dd + 1)
            contrib = torch.where(ok, ratio * (1.0 + dep[:, dst_c]), 0)
            dep = dep + self.ops.psum(self._segsum(contrib.T.contiguous(), src_key, "src")).T
        dep[lane, src] = 0.0
        return dep

    def _bellman_ford(self, dist, frontier, unit: bool = False) -> torch.Tensor:
        """The (min, +) relaxation shared by ``sssp_batch`` and
        ``sssp_batch_from``, one pmin per round; ``unit=True`` forces unit
        weights (the hop metric on a weighted pool)."""
        p, a = self._views()
        n, S = self._n, self._S
        unweighted = unit or p.vals is None
        w_pool = torch.ones(p.data.numel(), device=self.device) if unweighted \
            else p.vals.reshape(-1)  # read at expanded pool slots
        w_dst = torch.ones(a.src_by_dst.numel(), device=self.device) if unweighted \
            else a.w_by_dst.reshape(-1)
        sbd = a.src_by_dst.reshape(-1).long()
        vbd = a.valid_by_dst.reshape(-1)[None, :]
        dst_seg = None
        thresh = self._thresh()
        f, d = frontier, dist
        while True:
            go, dense = _sync(f.any(), _use_dense(f, a.deg_total, thresh))
            if not go:
                break
            if dense:
                if dst_seg is None:
                    dst_seg = _dst_seg(a, n)
                msg = torch.where(f[:, sbd] & vbd, d[:, sbd] + w_dst[None, :], math.inf)
                cand = self.ops.pmin(_seg_partials(msg, dst_seg, S, n, math.inf, "amin"))
            else:
                us, vs, ev, slot, shard = self._expand(p, f, self._auto_ids_budget,
                                                       self._auto_edge_budget)
                vals = torch.where(ev, d.gather(1, us.long()) + w_pool[slot], math.inf)
                spread = torch.arange(ev.shape[1], device=self.device) % n
                seg = shard * n + torch.where(ev, vs.long(), spread)
                cand = self.ops.pmin(_seg_partials(vals, seg, S, n, math.inf, "amin"))
            f = cand < d
            d = torch.where(f, cand, d)
        return d

    def sssp_batch(self, sources) -> torch.Tensor:
        """Multi-source Bellman–Ford distances float[B, n] (+inf =
        unreached), bit-identical to ``TorchEngine.sssp_batch``."""
        src = _lanes(sources, self.device)
        B = src.shape[0]
        lane = torch.arange(B, device=self.device)
        dist = torch.full((B, self._n), math.inf, device=self.device)
        dist[lane, src] = 0.0
        frontier = torch.zeros((B, self._n), dtype=torch.bool, device=self.device)
        frontier[lane, src] = True
        return self._bellman_ford(dist, frontier)

    def sssp_batch_from(self, dist0, frontier0, unit: bool = False) -> torch.Tensor:
        """Warm-start (min, +) relaxation from arbitrary initial state."""
        dist0 = torch.as_tensor(np.asarray(dist0), device=self.device).float()
        frontier0 = torch.as_tensor(np.asarray(frontier0, bool), device=self.device)
        return self._bellman_ford(dist0, frontier0, unit=unit)

    # -- vertexMap ----------------------------------------------------------
    def vertex_map(self, U: TorchVertexSubset, P: Callable, state) -> TorchVertexSubset:
        keep = P(self.ops, state, torch.arange(self._n, dtype=torch.int32, device=self.device))
        return self._subset(U.dense & keep)

    def to_host(self, x) -> np.ndarray:
        HOST_SYNCS.bump()
        return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# compressed sharded backend: queries over CompressedShardedGraph
# ---------------------------------------------------------------------------


class CompressedShardAux(NamedTuple):
    """Per-shard derived state for ``CompressedShardedEngine``:
    ``ShardAux`` with its two O(cap) int lanes chunk-compressed per row
    (``dst_sorted`` ascending, ``src_by_dst`` ascending within each dst
    segment); ``valid_by_dst`` collapses to one count per row (valid
    slots are the sorted prefix).  The O(S·n) arrays stay raw."""

    dst_sorted_c: cz.ChunkedStream  # (S, ...) destinations ascending
    srcbd_c: cz.ChunkedStream  # (S, ...) sources permuted dst-major
    dst_offsets: torch.Tensor  # int32[S, n+1]
    degrees: torch.Tensor  # int32[S, n]
    deg_total: torch.Tensor  # int64[n]
    m_valid: torch.Tensor  # int32[S] valid slots per row
    w_by_dst: Optional[torch.Tensor] = None  # float32[S, capC] dst-major


def shard_aux_compressed(cp: CompressedShardedPool, n: int, aux_hi_cap: Optional[int] = None,
                         ops: Optional[ShardedOps] = None) -> CompressedShardAux:
    """Decompress -> ``shard_aux`` -> re-compress the two big int lanes per
    row with the pool stream's width and escape capacity.  An adaptive
    pool gets adaptive aux lanes with the pool's hi capacity unless
    ``aux_hi_cap`` overrides it (the engine retries at full capacity when
    only the aux lanes overflow)."""
    aux = shard_aux(decompress_pool(cp), n, ops)
    k = cp.dst.k
    if cp.dst.adaptive:
        hc = cp.dst.hi_cap if aux_hi_cap is None else aux_hi_cap
        enc = lambda v: cz.encode_rows_adaptive(v, hi_cap=hc, k=k)  # noqa: E731
    else:
        enc = lambda v: cz.encode_rows(v, width=cp.dst.width, k=k)  # noqa: E731
    return CompressedShardAux(
        dst_sorted_c=enc(aux.dst_sorted),
        srcbd_c=enc(aux.src_by_dst),
        dst_offsets=aux.dst_offsets,
        degrees=aux.degrees,
        deg_total=aux.deg_total,
        m_valid=aux.evalid.sum(1).to(torch.int32),
        w_by_dst=aux.w_by_dst,
    )


def _inflate_sharded(cp: CompressedShardedPool, caux: CompressedShardAux, n: int,
                     width: int) -> _Views:
    """(pool, aux) -> the raw views a query reads, each row's first
    ``width`` slots, decoded per query (one decode-kernel call per lane on
    the card) and dropped after it.  The forward lanes are recomputed from
    the decoded keys; the dst-major permutation lanes decode from their
    streams."""
    p = decompress_pool(cp, width)
    cap = p.data.shape[1]
    R = cap // cz.CHUNK
    src_c, dst_c, evalid = _row_endpoints(p.data, p.n, n)
    return _Views(p, ShardAux(
        offsets=cp.offsets,
        src_c=src_c,
        dst_c=dst_c,
        evalid=evalid,
        degrees=caux.degrees,
        deg_total=caux.deg_total,
        dst_sorted=cz.decode_rows_batched(cz.row_prefix(caux.dst_sorted_c, R)),
        src_by_dst=cz.decode_rows_batched(cz.row_prefix(caux.srcbd_c, R)),
        valid_by_dst=torch.arange(cap, device=p.device)[None, :] < caux.m_valid[:, None],
        dst_offsets=caux.dst_offsets,
        w_by_dst=None if caux.w_by_dst is None else caux.w_by_dst[:, :cap].contiguous(),
    ))


def _any_spilled(ops: ShardedOps, *streams: cz.ChunkedStream) -> bool:
    """Whether a stream spilled on any row of any rank (every rank then
    takes the same branch)."""
    return bool(ops.pmax(torch.stack([s.spill.any() for s in streams]).any()[None]))


class CompressedShardedEngine(ShardedEngine):
    """``ShardedEngine`` served from a chunk-compressed resident pool.

    Holds a ``CompressedShardedPool`` + ``CompressedShardAux``; every query
    decodes the raw views it reads (``_inflate_sharded``), and the (+, x)
    reduce runs the chunked segment-sum kernels over the compressed
    ``dst_sorted`` lane, which decode inside the kernel: the operand is
    never inflated outside the reduce (the reference's fused-decode
    contract)."""

    def __init__(self, csg: CompressedShardedGraph, aux: Optional[CompressedShardAux] = None,
                 mesh: Optional[PoolMesh] = None):
        self.csg = csg
        self.mesh = pool_mesh(csg.n_shards, csg.device) if mesh is None else mesh
        self._check_mesh(csg.n_shards)
        self.ops = ShardedOps(self.mesh, csg.pool.rows)
        self.caux = shard_aux_compressed(csg.pool, csg.n, ops=self.ops) if aux is None else aux
        # one read of the flags at construction: a spilled stream would
        # mis-decode every query
        pool_spilled = _any_spilled(self.ops, csg.pool.dst)
        aux_spilled = _any_spilled(self.ops, self.caux.dst_sorted_c, self.caux.srcbd_c)
        if not pool_spilled and aux_spilled and aux is None and csg.pool.dst.adaptive:
            # the adaptive aux lanes inherited the pool's exact-fit hi
            # capacity but need more wide chunks: retry once at full capacity
            R = csg.pool.dst.deltas.shape[-2]
            self.caux = shard_aux_compressed(csg.pool, csg.n, R, ops=self.ops)
            aux_spilled = _any_spilled(self.ops, self.caux.dst_sorted_c, self.caux.srcbd_c)
        if pool_spilled or aux_spilled:
            raise ValueError("compressed sharded stream spilled its escape lane; "
                             "rebuild with a wider delta lane or keep the raw engine")
        self._setup(csg.n, graph_num_edges(csg, self.mesh), csg.n_shards, csg.pool.cap_per,
                    csg.pool, csg.pool.offsets, self.caux.dst_offsets)

    def _views(self) -> _Views:
        return _inflate_sharded(self.csg.pool, self.caux, self._n, self._width)

    @property
    def degrees(self) -> torch.Tensor:
        return self.caux.deg_total

    @property
    def weights(self) -> Optional[torch.Tensor]:
        return self.csg.pool.vals

    @property
    def resident_nbytes(self) -> int:
        """Device bytes held per snapshot: compressed pool + compressed aux."""
        return cz.pytree_nbytes(self.csg.pool) + cz.pytree_nbytes(self.caux)

    def _reduce_cols(self, values_b: torch.Tensor) -> torch.Tensor:
        """The (+, x) reduce on compressed operands: the source lane is
        decoded (a gather needs materialized indices); the chunked
        ``dst_sorted`` lane goes to the chunked segment-sum kernel as is,
        one launch per shard row over its live chunks."""
        c = self.caux
        n, S = self._n, self._S
        R = self._width // cz.CHUNK
        sbd = cz.decode_rows_batched(cz.row_prefix(c.srcbd_c, R))  # (S, width)
        cap = sbd.shape[1]
        valid = torch.arange(cap, device=self.device)[None, :] < c.m_valid[:, None]
        msg = torch.where(valid.reshape(-1)[None, :], values_b[:, sbd.reshape(-1).long()], 0)
        msg = msg.T.float().contiguous()
        D = msg.shape[1]
        w = None if c.w_by_dst is None else c.w_by_dst[:, :cap]
        m3 = msg.view(S, cap, D)
        parts = msg.new_zeros((S, n, D))
        f = c.dst_sorted_c
        for s, (L, lo, hi) in enumerate(self._rows["dst"]):
            if L == 0:
                continue
            R = -(-L // cz.CHUNK)  # the row's live chunks; its tail pads drop
            st = cz.ChunkedStream(f.anchors[s, :R] - lo, f.deltas[s, :R], f.ovf_pos[s, :R],
                                  f.ovf_add[s, :R], f.spill[s],
                                  None if f.hi is None else f.hi[s],
                                  None if f.wide is None else f.wide[s, :R])
            L = R * cz.CHUNK
            parts[s, lo: hi + 1] = _chunked_sum(st, m3[s, :L], hi - lo + 1,
                                                None if w is None else w[s, :L])
        return self.ops.psum_scatter(parts)


def _chunked_sum(s: cz.ChunkedStream, msg, n_out: int, w=None) -> torch.Tensor:
    if w is None:
        return kops.segment_sum_chunked(s.anchors, s.deltas, s.ovf_pos, s.ovf_add, msg, n_out,
                                        hi=s.hi, wide=s.wide)
    return kops.segment_sum_weighted_chunked(s.anchors, s.deltas, s.ovf_pos, s.ovf_add, w, msg,
                                             n_out, hi=s.hi, wide=s.wide)
