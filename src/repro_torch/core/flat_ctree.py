"""Flat C-tree on the device: a sorted element pool plus a valid count.

Counterpart of ``repro/core/flat_ctree.py:41-341``, with its host-driven
set API (``empty``, ``find``, ``chunk_ids``, ``multi_insert``,
``multi_delete``) over the same device operations.  The C-tree's
insight — hash-canonical chunk boundaries over a sorted pool — survives
in flat form:

  data[capacity] : sorted element pool (padding = SENTINEL at the top)
  n              : int32 0-dim tensor, the valid count (on the device)
  vals           : optional value per element (the PaC-tree key->value
                   generalization), permuted alongside every merge

Every operation is a fixed-shape torch op that stays on the device: the
valid count is never read back, and the scatters that compact a pool
route dropped lanes to one sink slot past the end, which is sliced off
(torch has no ``mode="drop"``).  Value semantics are the reference's:
a union lets a batch element OVERWRITE an existing key's value, within
one batch the FIRST occurrence of a duplicate key wins, and a difference
drops a key's value with it.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import resolve
from .hash import is_head_torch

SENTINEL32 = int(np.iinfo(np.int32).max)
SENTINEL64 = int(np.iinfo(np.int64).max)


def sentinel_for(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return int(torch.iinfo(dtype).max)
    return int(np.iinfo(np.dtype(dtype)).max)


class FlatCTree(NamedTuple):
    data: torch.Tensor  # [capacity] sorted; data[n:] == SENTINEL
    n: torch.Tensor  # int32 0-dim
    vals: Optional[torch.Tensor] = None  # [capacity] associated values (pad 0)


def capacity(t: FlatCTree) -> int:
    return t.data.shape[0]


def empty(cap: int, dtype=torch.int32, device=None) -> FlatCTree:
    """A pool of ``cap`` sentinel slots and no element."""
    dev = resolve(device)
    return FlatCTree(torch.full((cap,), sentinel_for(dtype), dtype=dtype, device=dev),
                     torch.zeros((), dtype=torch.int32, device=dev))


def from_array(
    values: np.ndarray,
    cap: int | None = None,
    dtype=torch.int32,
    vals: np.ndarray | None = None,
    device=None,
) -> FlatCTree:
    """Host build: sort+dedup then pad to capacity.  ``vals`` optionally
    attaches one float32 value per element (duplicate keys keep the FIRST
    occurrence's value)."""
    dev = resolve(device)
    raw = np.asarray(values)
    if vals is None:
        v = np.unique(raw)
        w = None
    else:
        v, first = np.unique(raw, return_index=True)
        w = np.asarray(vals).reshape(-1)[first]
    if cap is None:
        cap = grown_capacity(v.size)
    if v.size > cap:
        raise ValueError(f"{v.size} elements exceed capacity {cap}")
    data = torch.full((cap,), sentinel_for(dtype), dtype=dtype)
    data[: v.size] = torch.from_numpy(v.astype(np.int64)).to(dtype)
    n = torch.tensor(v.size, dtype=torch.int32)
    if w is None:
        return FlatCTree(data.to(dev), n.to(dev))
    wdata = torch.zeros(cap, dtype=torch.float32)
    wdata[: v.size] = torch.from_numpy(np.asarray(w, np.float32))
    return FlatCTree(data.to(dev), n.to(dev), wdata.to(dev))


def from_state(data, n, vals=None, device=None) -> FlatCTree:
    """A pool from the reference's leaves as numpy arrays
    (``np.asarray(t.data)``, ``int(t.n)``, ``np.asarray(t.vals)``)."""
    dev = resolve(device)
    return FlatCTree(
        torch.from_numpy(np.array(data)).to(dev),
        torch.tensor(int(n), dtype=torch.int32, device=dev),
        None if vals is None else torch.from_numpy(np.array(vals)).to(dev),
    )


def to_array(t: FlatCTree) -> np.ndarray:
    return t.data[: int(t.n)].cpu().numpy()


def to_val_array(t: FlatCTree) -> np.ndarray | None:
    """The valid prefix of the value array (None on plain sets)."""
    return None if t.vals is None else t.vals[: int(t.n)].cpu().numpy()


def from_device(values: torch.Tensor, cap: int, vals: torch.Tensor | None = None) -> FlatCTree:
    """Device-side build: sort + dedup + compact.  Sentinel-valued slots
    are dropped, so a caller may pre-pad to a quantized shape.  ``vals``
    rides along through a stable sort, so the first occurrence of a
    duplicate key keeps its value."""
    flat = values.reshape(-1)
    if vals is None:
        v = torch.sort(flat).values
        return _compact(v, _dedup_mask(v, v.shape[0]), cap)
    v, order = torch.sort(flat, stable=True)
    return _compact(v, _dedup_mask(v, v.shape[0]), cap, vals=vals.reshape(-1)[order])


# ---------------------------------------------------------------------------
# membership / find
# ---------------------------------------------------------------------------


def member(t: FlatCTree, queries: torch.Tensor) -> torch.Tensor:
    """Vectorized Find: bool per query (padding-safe)."""
    idx = torch.searchsorted(t.data, queries).clamp_max_(t.data.shape[0] - 1)
    return (t.data[idx] == queries) & (queries != sentinel_for(t.data.dtype))


def find(t: FlatCTree, e: int) -> bool:
    return bool(member(t, torch.tensor([e], dtype=t.data.dtype, device=t.data.device))[0])


# ---------------------------------------------------------------------------
# head / chunk structure (canonical, derived)
# ---------------------------------------------------------------------------


def head_mask(t: FlatCTree, b: int, seed: int) -> torch.Tensor:
    """is_head over valid elements (one hash pass)."""
    valid = torch.arange(t.data.shape[0], device=t.data.device) < t.n
    return is_head_torch(t.data, b, seed) & valid


def chunk_ids(t: FlatCTree, b: int, seed: int) -> torch.Tensor:
    """int32 chunk id per slot: the prefix is 0, the tail of the i-th head i + 1."""
    return torch.cumsum(head_mask(t, b, seed), 0, dtype=torch.int32)


def num_heads(t: FlatCTree, b: int, seed: int) -> int:
    return int(head_mask(t, b, seed).sum())


# ---------------------------------------------------------------------------
# batch union: baseline (sort) and optimized (rank-merge)
# ---------------------------------------------------------------------------


def _dedup_mask(sorted_data: torch.Tensor, n_total) -> torch.Tensor:
    keep = torch.ones(sorted_data.shape, dtype=torch.bool, device=sorted_data.device)
    keep[1:] = sorted_data[1:] != sorted_data[:-1]
    keep &= torch.arange(sorted_data.shape[0], device=sorted_data.device) < n_total
    keep &= sorted_data != sentinel_for(sorted_data.dtype)
    return keep


def _scatter(out: torch.Tensor, pos: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``out[pos] = src`` where ``pos == len(out)`` drops the lane: the
    write goes to a sink slot past the end, which is sliced off."""
    ext = torch.cat([out, out[:1]])
    ext[pos] = src
    return ext[:-1]


def _compact(
    values: torch.Tensor, keep: torch.Tensor, out_cap: int, vals: torch.Tensor | None = None
) -> FlatCTree:
    """Scatter kept values to the front of a fresh pool (associated
    values, when present, ride the same permutation)."""
    pos = torch.cumsum(keep, 0) - 1
    pos = torch.where(keep, pos, out_cap)
    out = torch.full((out_cap,), sentinel_for(values.dtype), dtype=values.dtype,
                     device=values.device)
    out = _scatter(out, pos, values)
    n_out = keep.sum().to(torch.int32)
    if vals is None:
        return FlatCTree(out, n_out)
    vout = _scatter(torch.zeros(out_cap, dtype=vals.dtype, device=vals.device), pos, vals)
    return FlatCTree(out, n_out, vout)


def _aligned_vals(t: FlatCTree, batch: FlatCTree):
    """(vals_a, vals_b) for a union, or (None, None) when both inputs
    are plain sets.  A mixed union materializes the value-less side as
    unit weights (an unweighted pool receiving its first weighted batch,
    or a weighted pool receiving a weight-less batch)."""
    if t.vals is None and batch.vals is None:
        return None, None
    dt = t.vals.dtype if t.vals is not None else batch.vals.dtype
    va = t.vals if t.vals is not None else torch.ones(t.data.shape[0], dtype=dt,
                                                      device=t.data.device)
    vb = batch.vals if batch.vals is not None else torch.ones(batch.data.shape[0], dtype=dt,
                                                              device=batch.data.device)
    return va, vb


def union_sort(t: FlatCTree, batch: FlatCTree, out_cap: int) -> FlatCTree:
    """Baseline MultiInsert: concat + sort + dedup + compact.  With
    values the sort is stable and a duplicated key keeps the BATCH value
    (the pool copy sorts first; each kept slot reads the last value of
    its equal-run, runs being at most 2 long)."""
    va, vb = _aligned_vals(t, batch)
    allk = torch.cat([t.data, batch.data])
    if va is None:
        allv = torch.sort(allk).values
        return _compact(allv, _dedup_mask(allv, t.n + batch.n), out_cap)
    allv, order = torch.sort(allk, stable=True)
    vals = torch.cat([va, vb])[order]
    keep = _dedup_mask(allv, t.n + batch.n)
    nxt_same = torch.cat([allv[1:] == allv[:-1], torch.zeros(1, dtype=torch.bool,
                                                              device=allv.device)])
    vals = torch.where(nxt_same, torch.roll(vals, -1), vals)  # batch overwrites
    return _compact(allv, keep, out_cap, vals=vals)


def union_merge(t: FlatCTree, batch: FlatCTree, out_cap: int) -> FlatCTree:
    """Optimized MultiInsert: O(n+k) rank-merge.

    Output position of an a-element = own index + #unique-b-elements
    below it; of a kept b-element = #a-below + #kept-b-below.  Two
    searchsorteds and one scatter, no sort."""
    a, b = t.data, batch.data
    dev = a.device
    ca, cb = a.shape[0], b.shape[0]
    valid_a = torch.arange(ca, device=dev) < t.n
    valid_b = torch.arange(cb, device=dev) < batch.n

    # which b are duplicates of an a element?
    rb = torch.searchsorted(a, b)  # #a < b[j]
    ia = rb.clamp_max(ca - 1)
    dup_b = (a[ia] == b) & valid_b
    keep_b = valid_b & ~dup_b
    kb_incl = torch.cumsum(keep_b, 0)
    kb_excl = kb_incl - keep_b.long()  # exclusive prefix

    ra = torch.searchsorted(b, a)  # #b-entries < a[i] (b pads are max)
    kept_below_a = torch.where(ra > 0, kb_incl[(ra - 1).clamp(0, cb - 1)], 0)
    pos_a = torch.arange(ca, device=dev) + kept_below_a
    pos_a = torch.where(valid_a, pos_a, out_cap)

    pos_b = torch.where(keep_b, rb + kb_excl, out_cap)

    out = a.new_full((out_cap,), sentinel_for(a.dtype))
    out = _scatter(_scatter(out, pos_a, a), pos_b, b)
    n_out = (t.n + keep_b.sum()).to(torch.int32)
    va, vb = _aligned_vals(t, batch)
    if va is None:
        return FlatCTree(out, n_out)
    # values ride the same two scatters; a duplicate b key lands its value
    # on the matched a slot (insert overwrites, PaC-tree style)
    vout = va.new_zeros(out_cap)
    vout = _scatter(_scatter(vout, pos_a, va), pos_b, vb)
    pos_dup = torch.where(dup_b, pos_a[ia], out_cap)
    vout = _scatter(vout, pos_dup, vb)
    return FlatCTree(out, n_out, vout)


def difference(t: FlatCTree, batch: FlatCTree, out_cap: int) -> FlatCTree:
    """MultiDelete: drop elements of t found in batch; compact (a dropped
    key drops its associated value)."""
    drop = member(batch, t.data)
    valid = torch.arange(t.data.shape[0], device=t.data.device) < t.n
    return _compact(t.data, valid & ~drop, out_cap, vals=t.vals)


def intersect(t: FlatCTree, batch: FlatCTree, out_cap: int) -> FlatCTree:
    keep = member(batch, t.data) & (torch.arange(t.data.shape[0], device=t.data.device) < t.n)
    return _compact(t.data, keep, out_cap, vals=t.vals)


# ---------------------------------------------------------------------------
# host-side capacity policy
# ---------------------------------------------------------------------------


def grown_capacity(n_needed: int) -> int:
    """Power-of-two quantization of pool capacities (amortized growth)."""
    return max(8, int(2 ** np.ceil(np.log2(n_needed + 1))))


def multi_insert(
    t: FlatCTree,
    values: np.ndarray,
    optimized: bool = True,
    vals: np.ndarray | None = None,
) -> FlatCTree:
    """Host-driven batch insert: build the batch on t's device, pick a
    capacity, run the union.  t is left as it was (a new pool)."""
    batch = from_array(values, dtype=t.data.dtype, vals=vals, device=t.data.device)
    need = int(t.n) + int(batch.n)
    cap = max(capacity(t), grown_capacity(need))
    fn = union_merge if optimized else union_sort
    return fn(t, batch, cap)


def multi_delete(t: FlatCTree, values: np.ndarray) -> FlatCTree:
    """Host-driven batch delete (a new pool of t's capacity)."""
    batch = from_array(values, dtype=t.data.dtype, device=t.data.device)
    return difference(t, batch, capacity(t))
