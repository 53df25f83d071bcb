"""Range-sharded pool on the device: the sharded mirror's substrate.

Counterpart of ``repro/core/sharded_pool.py`` (lines 1-844).  Each shard
row owns a contiguous KEY RANGE of the packed ``(src << 32) | dst`` pool,
like the levels of a distributed LSM tree.  A batch update is:

  1. the (small) batch goes to every shard (the one collective, an
     all-gather of O(batch) bytes, logged by ``ShardedOps``);
  2. every shard slices the batch rows in its key range (two
     searchsorteds against its own boundaries);
  3. a shard-local rank-merge into its own slack capacity.

Traffic is O(batch), never a global O(pool) rank-merge.  When a shard
nears its capacity, or the occupancy skews, the host triggers a
REBALANCE: an O(m) redistribution to equal counts, amortised over many
updates like an LSM compaction.

The reference runs the shard rows as blocks of a device mesh under
``shard_map``.  The port runs them as blocks of ranks: ``PoolMesh(size=k,
rank=r)`` gives rank ``r`` the ``S / k`` rows ``[r S/k, (r+1) S/k)`` as
stacked ``[S/k, cap_per]`` tensors on its device, every shard-local step
is one batched pass over those rows (no Python loop over shards), and
every cross-rank merge goes through ``traversal/sharded_backend.
ShardedOps``: a reduction over the local rows, then a
``torch.distributed`` collective (ROADMAP.md item 16, first half).  The
boundary table ``lo`` stays whole on every rank (S keys): it routes a
key to its row wherever the row lives.  One rank (no process group)
holds all ``S`` rows, and every collective is the local reduction.
``pool_mesh`` and ``default_n_shards`` read the process group when one
is up; the divisibility guard is the reference's.  Every rank applies
the same host batches in the same order, so the host policy
(rebalance, capacity) reads the same global counts and decides alike;
``assert_same_decision`` checks that once a publish.

Graph substrate (DESIGN.md §9): the optional VALUE LANE carries one
float32 per slot (insert overwrites, delete drops), ``shard_aux``
derives the per-shard CSR the sharded engine reads, and
``ShardedGraph`` pairs the pool with its static vertex count.  The
compressed half (``CompressedShardedPool``) chunk-compresses each row's
dst lane with ``core/compressed.py``; its update steps decompress,
rank-merge and recompress, so the resident state stays compressed.
Every lane is bit-identical to the reference's.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import resolve
from . import compressed as cz
from .flat_ctree import SENTINEL64

SENT = SENTINEL64
_INT64_MIN = int(np.iinfo(np.int64).min)
_INT64_MAX = int(np.iinfo(np.int64).max)


class ShardedPool(NamedTuple):
    """Range-sharded sorted pool.

    data : int64[R, cap_per] sorted within each shard; pad = SENT
    n    : int32[R] valid counts
    lo   : int64[S] inclusive lower key boundary of each shard (all S)
    vals : optional float32[R, cap_per] per-slot values (pad 0), permuted
           by every shard-local merge and compaction alongside the keys

    R is this rank's rows (``S / k``; all S on one rank)."""

    data: torch.Tensor
    n: torch.Tensor
    lo: torch.Tensor
    vals: Optional[torch.Tensor] = None

    @property
    def n_shards(self) -> int:
        return self.lo.shape[0]

    @property
    def rows(self) -> int:
        return self.data.shape[0]

    @property
    def cap_per(self) -> int:
        return self.data.shape[1]

    @property
    def device(self) -> torch.device:
        return self.data.device


class PoolMesh(NamedTuple):
    """The port's counterpart of the reference's one-axis device mesh:
    the device this rank's shard rows live on, ``size`` ranks along the
    ``shard`` axis and this process's ``rank``.  Each rank holds the
    block ``block(S)`` of ``S / size`` rows; ``size`` must divide the
    shard count (the reference's guard).  ``distributed``: the ranks are
    the default process group's, and every collective goes through it
    (at one rank too); without it one rank holds every row and a
    collective is the local reduction."""

    device: torch.device
    size: int = 1
    rank: int = 0
    distributed: bool = False

    @property
    def shape(self) -> dict:
        return {"shard": self.size}

    def block(self, n_shards: int) -> slice:
        """This rank's rows of ``n_shards``."""
        r = n_shards // self.size
        return slice(self.rank * r, (self.rank + 1) * r)


def _world() -> tuple:
    """(size, rank, whether a group is up) of the default process group,
    (1, 0, False) when none is up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank(), True
    return 1, 0, False


def pool_mesh(n_shards: int, device=None) -> PoolMesh:
    """The mesh for ``n_shards`` rows on ``device`` (``None`` = cuda): one
    rank per process of the default process group, or one rank holding
    every row when none is up."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    size, rank, up = _world()
    if n_shards % size:
        raise ValueError(f"n_shards={n_shards} must be a multiple of the mesh size {size}")
    return PoolMesh(resolve(device), size, rank, up)


def default_n_shards() -> int:
    """One shard row per rank: the process group's size, 1 without one
    (the reference: the device count)."""
    return _world()[0]


def from_array(
    values: np.ndarray,
    n_shards: int,
    cap_per: int | None = None,
    vals: np.ndarray | None = None,
    device=None,
    mesh: PoolMesh | None = None,
) -> ShardedPool:
    """Host build: dedup + range-partition to equal counts.  ``vals``
    optionally attaches one value per element (a duplicated key keeps the
    FIRST occurrence's value).  With ``mesh``, this rank's rows only (the
    boundaries of all)."""
    raw = np.asarray(values, dtype=np.int64)
    if vals is None:
        v = np.unique(raw)
        w = None
    else:
        v, first = np.unique(raw, return_index=True)
        w = np.asarray(vals, dtype=np.float32).reshape(-1)[first]
    per = -(-v.size // n_shards) if v.size else 1
    if cap_per is None:
        cap_per = max(8, int(2 ** np.ceil(np.log2(per * 2 + 1))))
    data = np.full((n_shards, cap_per), SENT, dtype=np.int64)
    wdata = np.zeros((n_shards, cap_per), dtype=np.float32) if w is not None else None
    n = np.zeros((n_shards,), dtype=np.int32)
    lo = np.full((n_shards,), _INT64_MIN, dtype=np.int64)
    # An EMPTY shard's lo starts strictly past every key stored before it
    # (last key + 1): with duplicated boundaries a query equal to the
    # boundary key would route to the last shard claiming that lo, an
    # empty one, and the insert step would store that key twice.
    next_lo = 0
    for s in range(n_shards):
        chunk = v[s * per: (s + 1) * per]
        data[s, : chunk.size] = chunk
        n[s] = chunk.size
        if chunk.size:
            lo[s] = chunk[0]
            next_lo = int(chunk[-1]) + 1
        else:
            lo[s] = next_lo
        if wdata is not None:
            wdata[s, : chunk.size] = w[s * per: (s + 1) * per]
    lo[0] = _INT64_MIN
    dev = resolve(device)
    blk = slice(None) if mesh is None else mesh.block(n_shards)
    return ShardedPool(
        torch.from_numpy(data[blk]).to(dev),
        torch.from_numpy(n[blk]).to(dev),
        torch.from_numpy(lo).to(dev),
        None if wdata is None else torch.from_numpy(wdata[blk]).to(dev),
    )


def from_sorted_device(keys: torch.Tensor, m: int, n_shards: int,
                       vals: torch.Tensor | None = None,
                       mesh: PoolMesh | None = None) -> ShardedPool:
    """Device build from an already sorted, deduplicated key lane whose
    first ``m`` slots are valid (a ``FlatGraph``'s pool): the same
    partition as ``from_array``, with no host round trip of the keys.
    With ``mesh``, this rank's rows only."""
    dev = keys.device
    per = -(-m // n_shards) if m else 1
    cap_per = max(8, int(2 ** np.ceil(np.log2(per * 2 + 1))))
    blk = range(n_shards)[slice(None) if mesh is None else mesh.block(n_shards)]
    data = torch.full((len(blk), cap_per), SENT, dtype=torch.int64, device=dev)
    wdata = None if vals is None else torch.zeros((len(blk), cap_per), device=dev)
    counts = [max(0, min(per, m - s * per)) for s in range(n_shards)]
    lo = [_INT64_MIN] * n_shards
    firsts = torch.stack([keys[min(s * per, max(m - 1, 0))] for s in range(n_shards)])
    lasts = torch.stack([keys[max(min((s + 1) * per, m) - 1, 0)] for s in range(n_shards)])
    firsts, lasts = firsts.tolist(), lasts.tolist()  # one host read of 2S keys
    next_lo = 0
    for s, c in enumerate(counts):
        if c:
            if s in blk:
                data[s - blk.start, :c] = keys[s * per: s * per + c]
                if wdata is not None:
                    wdata[s - blk.start, :c] = vals[s * per: s * per + c]
            lo[s] = firsts[s]
            next_lo = lasts[s] + 1
        else:
            lo[s] = next_lo
    lo[0] = _INT64_MIN
    return ShardedPool(
        data,
        torch.tensor(counts[blk.start: blk.stop], dtype=torch.int32, device=dev),
        torch.tensor(lo, dtype=torch.int64, device=dev),
        wdata,
    )


def from_state(data, n, lo, vals=None, device=None) -> ShardedPool:
    """The port's pool from the reference's leaves as numpy arrays."""
    dev = resolve(device)

    def t(x, dt):
        return None if x is None else torch.from_numpy(np.array(x, dtype=dt)).to(dev)

    return ShardedPool(t(data, np.int64), t(n, np.int32), t(lo, np.int64), t(vals, np.float32))


def _valid_prefixes(rows: torch.Tensor, n: torch.Tensor) -> np.ndarray:
    mask = torch.arange(rows.shape[1], device=rows.device)[None, :] < n.to(rows.device)[:, None]
    return rows[mask].cpu().numpy()


def to_array(p: ShardedPool) -> np.ndarray:
    """The valid keys of the pool's rows in shard order (the sorted pool;
    on a rank, its block: ``gather_pool`` first for all of it)."""
    return _valid_prefixes(p.data, p.n)


def to_val_array(p: ShardedPool) -> np.ndarray | None:
    """Valid-prefix values aligned with ``to_array`` (None on plain sets)."""
    return None if p.vals is None else _valid_prefixes(p.vals, p.n)


def _ops(mesh: PoolMesh):
    from .traversal.sharded_backend import ShardedOps

    return ShardedOps(mesh)


def gather_pool(p: ShardedPool, mesh: PoolMesh | None = None) -> ShardedPool:
    """Every rank's rows gathered onto each rank (an O(pool) all-gather:
    the rebalance's compaction and checks read it); ``p`` itself on one
    rank."""
    if mesh is None or mesh.size == 1:
        return p
    ops = _ops(mesh)
    return ShardedPool(ops.gather_rows(p.data), ops.gather_rows(p.n), p.lo,
                       None if p.vals is None else ops.gather_rows(p.vals))


def shard_counts(p, mesh: PoolMesh | None = None) -> np.ndarray:
    """The valid counts of all S rows (one host read; the rows of every
    rank, gathered, under a process group)."""
    n = p.n if mesh is None or mesh.size == 1 else _ops(mesh).gather_rows(p.n)
    return n.cpu().numpy()


def assert_same_decision(mesh: PoolMesh | None, *decision) -> None:
    """Raise unless every rank passes the same ``decision`` (ints): one
    scalar all-reduce of a hash of it.  The host policy runs on every
    rank from the same batches and counts, so a difference is a fault."""
    if mesh is None or mesh.size == 1:
        return
    h = hash(tuple(int(d) for d in decision)) & ((1 << 40) - 1)
    if not _ops(mesh).same_on_every_rank(h):
        raise RuntimeError(f"rank {mesh.rank}: the host policy decided {decision}, "
                           "another rank decided otherwise")


def with_unit_vals(p: ShardedPool) -> ShardedPool:
    """Attach a unit value lane (the upgrade an unweighted pool takes when
    its first weighted batch arrives)."""
    if p.vals is not None:
        return p
    return p._replace(vals=torch.ones(p.data.shape, dtype=torch.float32, device=p.device))


# ---------------------------------------------------------------------------
# shard-local update steps: one batched pass over all [S, cap_per] rows
# ---------------------------------------------------------------------------


def _scatter_rows(out: torch.Tensor, pos: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Row-wise ``out[s, pos[s, j]] = src[s, j]`` where a position at or
    past the row's end drops the lane (into a sink column, sliced off)."""
    cap = out.shape[1]
    ext = torch.cat([out, out[:, :1]], dim=1)
    ext.scatter_(1, pos.clamp(max=cap).long(), src)
    return ext[:, :cap].contiguous()


def _hi_bounds(lo: torch.Tensor) -> torch.Tensor:
    return torch.cat([lo[1:], lo.new_full((1,), _INT64_MAX)])


def _local_merge(data, n, lo, hi, batch, vals=None, bvals=None):
    """Merge each shard's slice of the sorted, deduplicated, SENT-padded
    batch into its own row (fixed shapes, O(cap + k) per row): the
    reference's vmapped ``_local_merge``.  The value lane rides the same
    two scatters; a duplicate batch key lands its value on the matched
    pool slot (insert overwrites)."""
    S, cap = data.shape
    kcap = batch.shape[0]
    dev = data.device
    b_lo = torch.searchsorted(batch, lo)  # [S]
    b_hi = torch.searchsorted(batch, hi)
    n_mine = b_hi - b_lo
    j = torch.arange(kcap, device=dev)
    valid_b = j[None, :] < n_mine[:, None]
    take = (b_lo[:, None] + j[None, :]).clamp(max=kcap - 1)
    b = torch.where(valid_b, batch[take], SENT)  # this row's batch slice, SENT-padded
    valid_a = torch.arange(cap, device=dev)[None, :] < n[:, None]
    rb = torch.searchsorted(data, b)  # #a < b[j], per row
    ia = rb.clamp(max=cap - 1)
    dup_b = (data.gather(1, ia) == b) & valid_b
    keep_b = valid_b & ~dup_b
    kb_excl = torch.cumsum(keep_b, 1) - keep_b.long()
    ra = torch.searchsorted(b, data)  # #b < a[i], per row (b pads are SENT)
    r1 = (ra - 1).clamp(0, kcap - 1)
    kept_below_a = torch.where(ra > 0, kb_excl.gather(1, r1) + keep_b.gather(1, r1).long(), 0)
    pos_a = torch.where(valid_a, torch.arange(cap, device=dev)[None, :] + kept_below_a, cap)
    pos_b = torch.where(keep_b, rb + kb_excl, cap)
    out = torch.full((S, cap), SENT, dtype=torch.int64, device=dev)
    out = _scatter_rows(_scatter_rows(out, pos_a, data), pos_b, b)
    n_new = (n + keep_b.sum(1)).to(torch.int32)
    if vals is None:
        return out, n_new, None
    bv = torch.where(valid_b, bvals[take], 0)
    vout = torch.zeros((S, cap), dtype=vals.dtype, device=dev)
    vout = _scatter_rows(_scatter_rows(vout, pos_a, vals), pos_b, bv)
    pos_dup = torch.where(dup_b, pos_a.clamp(max=cap).gather(1, ia), cap)
    return out, n_new, _scatter_rows(vout, pos_dup, bv)


def make_insert_step(mesh: PoolMesh):
    """The shard-local insert step for ``mesh``: ``step(pool, batch,
    batch_vals=None)`` merges a sorted, deduped, SENT-padded batch into
    every shard's key range.  A value lane on either side upgrades the
    other to unit values (the ``flat_ctree._aligned_vals`` semantics).
    The batch is the step's one collective operand; each rank merges
    into its own rows, between its rows' boundaries."""
    ops = _ops(mesh)

    def step(pool: ShardedPool, batch: torch.Tensor,
             batch_vals: torch.Tensor | None = None) -> ShardedPool:
        batch = ops.all_gather(batch)
        blk = mesh.block(pool.n_shards)
        lo, hi = pool.lo[blk], _hi_bounds(pool.lo)[blk]
        if pool.vals is None and batch_vals is None:
            out, n_new, _ = _local_merge(pool.data, pool.n, lo, hi, batch)
            return ShardedPool(out, n_new, pool.lo)
        vals = pool.vals if pool.vals is not None else torch.ones(
            pool.data.shape, dtype=batch_vals.dtype, device=pool.device)
        bv = ops.all_gather(batch_vals) if batch_vals is not None else torch.ones(
            batch.shape, dtype=vals.dtype, device=batch.device)
        out, n_new, vout = _local_merge(pool.data, pool.n, lo, hi, batch, vals, bv)
        return ShardedPool(out, n_new, pool.lo, vout)

    return step


def _local_delete(data, n, batch, vals=None):
    """Each shard drops its keys found in the batch and compacts in place
    (boundaries unchanged: a delete never moves keys across ranges)."""
    S, cap = data.shape
    idx = torch.searchsorted(batch, data).clamp(max=batch.shape[0] - 1)
    hit = (batch[idx] == data) & (data != SENT)
    keep = (torch.arange(cap, device=data.device)[None, :] < n[:, None]) & ~hit
    pos = torch.where(keep, torch.cumsum(keep, 1) - 1, cap)
    out = _scatter_rows(torch.full_like(data, SENT), pos, data)
    n_new = keep.sum(1).to(torch.int32)
    vout = None if vals is None else _scatter_rows(torch.zeros_like(vals), pos, vals)
    return out, n_new, vout


def make_delete_step(mesh: PoolMesh):
    """Shard-local MultiDelete: ``step(pool, batch)`` (a dropped key drops
    its value-lane entry)."""
    ops = _ops(mesh)

    def step(pool: ShardedPool, batch: torch.Tensor) -> ShardedPool:
        out, n_new, vout = _local_delete(pool.data, pool.n, ops.all_gather(batch), pool.vals)
        return ShardedPool(out, n_new, pool.lo, vout)

    return step


# ---------------------------------------------------------------------------
# queries + rebalance policy (host-driven)
# ---------------------------------------------------------------------------


def member(p: ShardedPool, queries, mesh: PoolMesh | None = None) -> torch.Tensor:
    """Shard id from the boundary table, then a LOCAL probe by flat index
    math: a binary search over ``data.reshape(-1)[s * cap + mid]`` —
    O(queries · log cap) scalar gathers, never a (queries, cap) row
    gather.  Under ranks each rank probes the queries its rows own and a
    pmax merges the answers."""
    S, cap = p.data.shape
    q = (queries if torch.is_tensor(queries) else torch.from_numpy(np.asarray(queries))).to(
        p.device, torch.int64)
    flat = p.data.reshape(-1)
    s = torch.searchsorted(p.lo, q, right=True) - 1
    if mesh is not None and mesh.size > 1:
        r0 = mesh.block(p.n_shards).start
        mine = (s >= r0) & (s < r0 + S)
        hit = member(p._replace(lo=p.lo[r0: r0 + S]), q)
        return _ops(mesh).pmax((hit & mine)[None])
    s = s.clamp(0, S - 1)
    base = s * cap
    ns = p.n[s].to(torch.int64)
    lo = torch.zeros_like(q)
    hi = ns.clone()
    for _ in range(int(math.ceil(math.log2(cap))) + 1):
        active = lo < hi
        mid = (lo + hi) // 2
        v = flat[base + mid.clamp(max=cap - 1)]
        go_right = active & (v < q)
        lo = torch.where(go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    probe = flat[base + lo.clamp(max=cap - 1)]
    return (lo < ns) & (probe == q)


def needs_rebalance(p: ShardedPool, slack: float = 0.9) -> bool:
    return bool((p.n.cpu().numpy() >= slack * p.data.shape[1]).any())


def rebalance(p: ShardedPool, cap_per: int | None = None,
              mesh: PoolMesh | None = None) -> ShardedPool:
    """O(m) redistribution to equal counts (the amortised compaction); the
    value lane, when present, is preserved through the round trip.  Under
    ranks every rank gathers all rows, partitions them alike and keeps
    its own block."""
    g = gather_pool(p, mesh)
    return from_array(
        to_array(g),
        p.n_shards,
        cap_per=p.data.shape[1] if cap_per is None else cap_per,
        vals=to_val_array(g),
        device=p.device,
        mesh=mesh,
    )


# ---------------------------------------------------------------------------
# graph substrate: packed-key pool + per-shard CSR aux (DESIGN.md §9)
# ---------------------------------------------------------------------------


class ShardedGraph(NamedTuple):
    """A graph over the range-sharded pool: keys are the packed
    ``(src << 32) | dst`` encoding, ``n`` is the STATIC vertex count.  The
    pool's value lane, when present, is the per-edge weight array."""

    pool: ShardedPool
    n: int

    @property
    def n_shards(self) -> int:
        return self.pool.n_shards

    @property
    def weighted(self) -> bool:
        return self.pool.vals is not None

    @property
    def device(self) -> torch.device:
        return self.pool.device


class ShardAux(NamedTuple):
    """Per-shard CSR auxiliary state: the shard-local ``EngineAux``, every
    field laid out (S, ...), built once per version by ``shard_aux``.

    offsets      : int32[S, n+1] CSR into each shard's OWN row
    src_c, dst_c : int32[S, cap] clipped endpoints per slot
    evalid       : bool[S, cap] slot holds a real edge with a real dst
    degrees      : int32[S, n] per-shard out-degree contribution
    deg_total    : int64[n] global out-degrees (the one cross-shard
                   reduction, once per version)
    dst_sorted   : int32[S, cap] destinations ascending per row (pad n)
    src_by_dst   : int32[S, cap] sources permuted dst-major per row
    valid_by_dst : bool[S, cap]
    dst_offsets  : int32[S, n+1] segment bounds into dst_sorted per row
    w_by_dst     : float32[S, cap] values dst-major, or None
    """

    offsets: torch.Tensor
    src_c: torch.Tensor
    dst_c: torch.Tensor
    evalid: torch.Tensor
    degrees: torch.Tensor
    deg_total: torch.Tensor
    dst_sorted: torch.Tensor
    src_by_dst: torch.Tensor
    valid_by_dst: torch.Tensor
    dst_offsets: torch.Tensor
    w_by_dst: Optional[torch.Tensor] = None


def _row_offsets(data: torch.Tensor, nrow: torch.Tensor, n: int) -> torch.Tensor:
    """int32[S, n+1]: each row's CSR offsets over its valid prefix."""
    S = data.shape[0]
    bounds = (torch.arange(n + 1, dtype=torch.int64, device=data.device) << 32).expand(S, -1)
    offs = torch.searchsorted(data, bounds.contiguous()).to(torch.int32)
    return torch.minimum(offs, nrow.to(torch.int32)[:, None])


def _row_endpoints(data: torch.Tensor, nrow: torch.Tensor, n: int):
    """(src_c, dst_c, evalid), each [S, cap]: a slot is usable iff it holds
    a real edge AND its destination is a real vertex."""
    cap = data.shape[1]
    src = (data >> 32).to(torch.int32)
    dst = (data & 0xFFFFFFFF).to(torch.int32)
    valid = torch.arange(cap, device=data.device)[None, :] < nrow[:, None]
    evalid = valid & (dst >= 0) & (dst < n)
    hi = max(n - 1, 0)
    return src.clamp(0, hi), dst.clamp(0, hi), evalid


def shard_aux(p: ShardedPool, n: int, ops=None) -> ShardAux:
    """Derive the per-shard CSR aux from the pool: one batched pass over
    the rows (each row's work touches only that row).  ``deg_total`` is
    the one cross-shard reduction (``ops.psum`` when given)."""
    offsets = _row_offsets(p.data, p.n, n)
    src_c, dst_c, evalid = _row_endpoints(p.data, p.n, n)
    degrees = torch.diff(offsets, dim=1)
    dst_key = torch.where(evalid, dst_c, n)
    dst_sorted, order = torch.sort(dst_key, dim=1, stable=True)
    S = p.data.shape[0]
    dst_offsets = torch.searchsorted(
        dst_sorted, torch.arange(n + 1, dtype=torch.int32, device=p.device).expand(S, -1)
        .contiguous()).to(torch.int32)
    deg_total = degrees.sum(0, dtype=torch.int32) if ops is None else ops.psum(degrees)
    return ShardAux(
        offsets=offsets,
        src_c=src_c,
        dst_c=dst_c,
        evalid=evalid,
        degrees=degrees,
        deg_total=deg_total.to(torch.int64),
        dst_sorted=dst_sorted,
        src_by_dst=src_c.gather(1, order),
        valid_by_dst=evalid.gather(1, order),
        dst_offsets=dst_offsets,
        w_by_dst=None if p.vals is None else p.vals.gather(1, order),
    )


def graph_from_edges(
    n: int,
    edges: np.ndarray,
    n_shards: int | None = None,
    weights: np.ndarray | None = None,
    cap_per: int | None = None,
    device=None,
    mesh: PoolMesh | None = None,
) -> ShardedGraph:
    """Host build from a (k, 2) directed edge array (dedups; a duplicated
    edge keeps the FIRST occurrence's weight); with ``mesh``, this rank's
    rows (default ``pool_mesh``: all rows on one rank)."""
    if n_shards is None:
        n_shards = default_n_shards()
    if mesh is None:
        mesh = pool_mesh(n_shards, device)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    packed = (edges[:, 0] << 32) | edges[:, 1]
    w = None if weights is None else np.asarray(weights, np.float32).reshape(-1)
    return ShardedGraph(from_array(packed, n_shards, cap_per=cap_per, vals=w, device=device,
                                   mesh=mesh), n)


def graph_to_edge_array(sg: ShardedGraph) -> np.ndarray:
    k = to_array(sg.pool)
    return np.stack([k >> 32, k & 0xFFFFFFFF], axis=1)


def graph_to_weight_array(sg: ShardedGraph) -> np.ndarray | None:
    return to_val_array(sg.pool)


def graph_num_edges(sg, mesh: PoolMesh | None = None) -> int:
    """Global edge count of a ShardedGraph or CompressedShardedGraph (a
    psum of the ranks' counts under ranks)."""
    if mesh is None or mesh.size == 1:
        return int(sg.pool.n.sum())
    return int(_ops(mesh).psum(sg.pool.n.long()))


# ---------------------------------------------------------------------------
# compressed sharded pool: each shard row's dst lane chunk-compressed
# (paper §3.2, sharded; the per-shard CompressedPool)
# ---------------------------------------------------------------------------


class CompressedShardedPool(NamedTuple):
    """ShardedPool with each row's dst lane chunk-compressed.

    offsets : int32[S, n+1] per-shard CSR over each row's valid prefix
    dst     : ChunkedStream with (S, ...) leaves (anchors (S, R), deltas
              (S, R, CHUNK), ovf_* (S, R, K), spill (S,), adaptive hi
              (S, H, CHUNK) and wide (S, R)); row capacity R * CHUNK
    n       : int32[S] valid counts
    lo      : int64[S] inclusive lower key boundary per shard
    vals    : optional float32[S, cap] value lane, uncompressed (pad 0)

    On a rank every leaf but ``lo`` holds its block's rows only."""

    offsets: torch.Tensor
    dst: cz.ChunkedStream
    n: torch.Tensor
    lo: torch.Tensor
    vals: Optional[torch.Tensor] = None

    @property
    def n_shards(self) -> int:
        return self.lo.shape[0]

    @property
    def rows(self) -> int:
        return self.offsets.shape[0]

    @property
    def cap_per(self) -> int:
        return self.dst.length

    @property
    def device(self) -> torch.device:
        return self.offsets.device


class CompressedShardedGraph(NamedTuple):
    """ShardedGraph over a CompressedShardedPool (static ``n``)."""

    pool: CompressedShardedPool
    n: int

    @property
    def n_shards(self) -> int:
        return self.pool.n_shards

    @property
    def weighted(self) -> bool:
        return self.pool.vals is not None

    @property
    def device(self) -> torch.device:
        return self.pool.device


def compress_pool(p: ShardedPool, n: int, width: int, k: int,
                  hi_cap: int | None = None) -> CompressedShardedPool:
    """ShardedPool -> CompressedShardedPool (lane width, escape capacity;
    ``hi_cap`` selects the adaptive layout).  No spill check:
    ``compress_sharded`` is the checked build."""
    cap = p.data.shape[1]
    offsets = _row_offsets(p.data, p.n, n)
    dst = (p.data & 0xFFFFFFFF).to(torch.int32)
    # Pad slots hold SENT (dst lane -1): carry the last valid dst forward
    # instead of encoding that cliff (decompress re-masks pad slots from n).
    last = dst.gather(1, (p.n.long() - 1).clamp(min=0)[:, None])
    dst_enc = torch.where(torch.arange(cap, device=p.device)[None, :] < p.n[:, None], dst, last)
    if hi_cap is not None:
        stream = cz.encode_rows_adaptive(dst_enc, hi_cap=hi_cap, k=k)
    else:
        stream = cz.encode_rows(dst_enc, width=width, k=k)
    vals = p.vals
    if vals is not None and stream.length > cap:
        vals = torch.cat([vals, vals.new_zeros((vals.shape[0], stream.length - cap))], dim=1)
    return CompressedShardedPool(offsets, stream, p.n, p.lo, vals)


def decompress_pool(cp: CompressedShardedPool, width: int | None = None) -> ShardedPool:
    """CompressedShardedPool -> ShardedPool: the exact inverse of
    ``compress_pool`` for rows that did not spill (pad slots come back as
    SENT); the row capacity is the chunked one, or the first ``width``
    slots of each row (a multiple of ``CHUNK``; a query needs no more
    than the fullest row's count).  The dst rows decode in one
    decode-kernel call on the card (``cz.decode_rows_batched``)."""
    capC = cp.cap_per if width is None else width
    dst = cz.decode_rows_batched(cz.row_prefix(cp.dst, capC // cz.CHUNK))  # (S, capC) int32
    S = dst.shape[0]
    slots = torch.arange(capC, dtype=cp.offsets.dtype, device=cp.device).expand(S, -1)
    src = (torch.searchsorted(cp.offsets, slots.contiguous(), right=True) - 1).to(torch.int64)
    packed = (src << 32) | (dst.to(torch.int64) & 0xFFFFFFFF)
    data = torch.where(torch.arange(capC, device=cp.device)[None, :] < cp.n[:, None], packed, SENT)
    return ShardedPool(data, cp.n, cp.lo, None if cp.vals is None else cp.vals[:, :capC])


def compress_sharded(
    sg: ShardedGraph,
    width: int | None = None,
    k: int = cz.OVF_SLOTS,
    hi_headroom: float = 0.0,
    mesh: PoolMesh | None = None,
) -> CompressedShardedGraph:
    """Checked build, mirroring ``flat_graph.compress_host``: the default
    is the ADAPTIVE layout (one int8 lane + a hi plane sized by the widest
    shard's wide-chunk count, plus ``hi_headroom`` slack rows for streaming
    growth); an explicit ``width`` (1 or 2) pins a fixed layout.  Raises
    ``ValueError`` if any shard row spills either way (keep the raw
    layout).  Under ranks (``mesh``) the spill flag and the hi plane's
    height are the all-rank ones, so every rank decides alike."""
    ops = None if mesh is None or mesh.size == 1 else _ops(mesh)

    def spilled(cp):
        flag = cp.dst.spill.any()
        return bool(flag if ops is None else ops.pmax(flag[None]))

    if width is None:
        cap = sg.pool.data.shape[1]
        R = (max(cap, 1) + cz.CHUNK - 1) // cz.CHUNK
        cp = compress_pool(sg.pool, sg.n, 0, k, R)
        if spilled(cp):
            raise ValueError(
                f"sharded pool spills the k={k} escape lane even at "
                "adaptive (int16-wide) chunks; keep the raw layout"
            )
        # exact-fit slice of the hi plane: one (S, H, CHUNK) leaf, so H is
        # the widest row's wide-chunk count (+ slack)
        wide = cp.dst.wide.sum(dim=-1).max()
        n_wide = int(wide if ops is None else ops.pmax(wide[None]))
        slack = 0 if hi_headroom <= 0 else max(4, int(np.ceil(hi_headroom * R)))
        hc = min(R, n_wide + slack)
        return CompressedShardedGraph(
            cp._replace(dst=cp.dst._replace(hi=cp.dst.hi[:, :hc].clone())), sg.n)
    cp = compress_pool(sg.pool, sg.n, width, k)
    if spilled(cp):
        raise ValueError(
            f"sharded pool spills the k={k} escape lane at the requested "
            "fixed width; keep the raw layout"
        )
    return CompressedShardedGraph(cp, sg.n)


def decompress_sharded(csg: CompressedShardedGraph) -> ShardedGraph:
    return ShardedGraph(decompress_pool(csg.pool), csg.n)


def _recompress(p2: ShardedPool, cp: CompressedShardedPool, n: int) -> CompressedShardedPool:
    """Re-encode an updated pool with the input stream's lane width (or
    hi capacity) and escape capacity; once a row spills it stays flagged
    until the pool is rebuilt (``_or_spill``)."""
    hi_cap = cp.dst.hi_cap if cp.dst.adaptive else None
    return _or_spill(compress_pool(p2, n, cp.dst.width, cp.dst.k, hi_cap), cp)


def _or_spill(out: CompressedShardedPool, cp: CompressedShardedPool) -> CompressedShardedPool:
    return out._replace(dst=out.dst._replace(spill=out.dst.spill | cp.dst.spill))


def make_insert_step_compressed(mesh: PoolMesh):
    """Compressed counterpart of ``make_insert_step``: ``step(cpool, batch,
    batch_vals=None, *, n)`` decompresses, rank-merges shard-locally and
    recompresses; the raw rows exist only inside the step.  Lane width and
    escape capacity are inherited from the input stream."""
    raw_step = make_insert_step(mesh)

    def step(cpool: CompressedShardedPool, batch: torch.Tensor,
             batch_vals: torch.Tensor | None = None, *, n: int) -> CompressedShardedPool:
        return _recompress(raw_step(decompress_pool(cpool), batch, batch_vals), cpool, n)

    return step


def make_delete_step_compressed(mesh: PoolMesh):
    """Compressed counterpart of ``make_delete_step``."""
    raw_step = make_delete_step(mesh)

    def step(cpool: CompressedShardedPool, batch: torch.Tensor, *,
             n: int) -> CompressedShardedPool:
        return _recompress(raw_step(decompress_pool(cpool), batch), cpool, n)

    return step


def needs_rebalance_compressed(cp: CompressedShardedPool, slack: float = 0.9) -> bool:
    return bool((cp.n.cpu().numpy() >= slack * cp.cap_per).any())


def rebalance_compressed(cp: CompressedShardedPool, n: int,
                         cap_per: int | None = None,
                         mesh: PoolMesh | None = None) -> CompressedShardedPool:
    """Host-side O(m) redistribution (decompress -> rebalance ->
    recompress).  Only sound on streams that did not spill."""
    p = rebalance(decompress_pool(cp), cap_per=cap_per, mesh=mesh)
    hi_cap = None
    if cp.dst.adaptive:
        # capacity may have grown: bound the plane by the new row capacity,
        # keeping at least the old plane's slack
        R = (max(p.data.shape[1], 1) + cz.CHUNK - 1) // cz.CHUNK
        hi_cap = min(R, max(cp.dst.hi_cap, 1))
    return compress_pool(p, n, cp.dst.width, cp.dst.k, hi_cap)


# ---------------------------------------------------------------------------
# shard auto-tuning: imbalance stats -> rebalance policy + shard-count hint
# ---------------------------------------------------------------------------


def _counts(p) -> np.ndarray:
    c = getattr(p, "n", p)
    c = c.cpu().numpy() if torch.is_tensor(c) else np.asarray(c)
    return c.astype(np.float64).reshape(-1)


def imbalance_stats(p) -> dict:
    """Occupancy skew from the counts the pool tracks: max / mean is the
    load-balance figure range partitioning degrades toward under skewed
    key streams.  Accepts either pool or a counts array."""
    counts = _counts(p)
    if counts.size == 0 or counts.sum() == 0:
        return {"max": 0.0, "mean": 0.0, "imbalance": 1.0}
    mean = float(counts.mean())
    mx = float(counts.max())
    return {"max": mx, "mean": mean, "imbalance": mx / mean if mean else 1.0}


def recommend_n_shards(m_total: int, target_per_shard: int = 1 << 16) -> int:
    """Shard-count hint: enough shards for ~``target_per_shard`` edges
    each, rounded up to a multiple of the rank count (the reference's
    device count) when more than one round is needed."""
    k = _world()[0]
    want = max(1, -(-int(m_total) // int(target_per_shard)))
    return want if want <= k else -(-want // k) * k


def should_rebalance(p, *, imbalance_threshold: float = 2.0, slack: float = 0.9,
                     counts=None) -> bool:
    """Auto-rebalance trigger: a shard nears capacity, OR max / mean
    occupancy exceeds ``imbalance_threshold``.  Works on both layouts;
    ``counts`` (all S rows, ``shard_counts``) stands in for the pool's
    own on a rank."""
    counts = _counts(p if counts is None else counts)
    near_cap = bool((counts >= slack * p.cap_per).any())
    return near_cap or imbalance_stats(counts)["imbalance"] > imbalance_threshold


def maybe_rebalance(p: ShardedPool, *, imbalance_threshold: float = 2.0, slack: float = 0.9):
    """``should_rebalance`` + the rebalance for raw pools; returns
    ``(pool, rebalanced)``."""
    if not should_rebalance(p, imbalance_threshold=imbalance_threshold, slack=slack):
        return p, False
    return rebalance(p), True
