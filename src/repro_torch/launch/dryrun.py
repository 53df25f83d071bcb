"""Multi-pod dry run: run every (arch x shape x mesh) cell on a fake mesh.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell for 256 or 512 placeholder host devices and reads
XLA's cost and memory analyses.  The port runs each cell's step eagerly
instead, in one process:

  * a default process group on the ``fake`` backend with world size 256
    or 512 (``fake_world``), this process being rank 0 — the counterpart
    of the reference's 512 placeholder devices;
  * the production ``DeviceMesh`` over it (``launch.mesh``), each
    argument a DTensor whose local shard is a meta tensor laid out by the
    cell's spec (``dist.shardings.placements``), so nothing is allocated;
  * ``step_fn`` run on them (training cells include the backward), and
    the outputs redistributed to the cell's ``out_specs``;
  * ``CostMode`` counting, below DTensor's dispatch, the FLOPs and bytes
    of every op on the local shards (per-device figures, as XLA's
    post-SPMD cost analysis gives) and recording every collective that
    DTensor issues (``launch.hlo_analysis``).

Where DTensor has no layout for an op of the cells, or one that differs
between its releases, the dry run states its own in the manner of the
reference's SPMD partitioner, and never replicates quietly: the
scatters, gathers and stacks of the cells take the strategies of
``_register_strategies``; a gather or scatter at positions in a dim the
operand shards runs masked on each rank's block (``CostMode._masked_local``
and ``_masked_gather``); the blockwise attention runs under
``local_map`` on each rank's batch and head shards
(``attention_on_local_shards``); a view DTensor cannot lay out gathers
the one mesh dim in its way.  Any other op DTensor cannot lay out, or
lays out with a local shard that does not match its layout, fails the
cell.  The report counts the resharded views and the masked ops.

The report keeps the reference's keys and meanings.  XLA's buffer
assignment has no counterpart, so ``mem_argument_bytes`` is the local
shards' size and ``fits`` holds the analytic ``mem_model`` total (the
argument bytes where a cell has no model) against one H100's 80 GB.
Bytes are counted per op (each op's tensor inputs read and outputs
written; a gather reads only the rows it returns; views move nothing),
with no fusion, so they bound XLA's fused count from above.

FLOPs follow XLA's cost analysis: matrix products, convolutions and
attention by torch's ``flop_registry``; a pointwise op one FLOP per
output element and a reduction one per input element, as
``HloCostAnalysis`` counts elementwise and reduce instructions; a
scatter that combines (an add, a max) one per update element.
Transcendentals (``exp``, ``log``, ``tanh``, ``sqrt``, ``pow``, the
sigmoid and its kin) are left out, as XLA counts them apart from its
FLOPs, and so are copies and fills, which XLA does not count.

Two layouts follow GSPMD where DTensor's differ:

  * a scatter from updates sharded along the entries into a target
    replicated on that mesh dim (``index_put`` with or without
    ``accumulate``, ``index_add``, ``scatter_add``, ``scatter_reduce``)
    runs as a local scatter on each rank, whose result is a partial, and
    one all-reduce of the target: SUM for an add, MAX for a max or a set
    of a boolean target (the cells set True), MIN for a min.  GSPMD
    partitions such a scatter the same way and never gathers its
    indices or values (``_scatter_partial``).  A plain set whose values
    differ per entry goes as a sum of each rank's changes, exact only
    where no two entries meet, as in the reference;
  * a softmax over a sharded dim runs as a local max, an all-reduce MAX
    of it, a local sum of the exponentials and an all-reduce SUM of the
    sums, which is how GSPMD partitions its reduce instructions; the
    scores are never gathered (``_sharded_softmax``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out dryrun.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import re
import sys
import time
import traceback
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import registry
from ..dist import shardings as SH
from . import hlo_analysis
from . import mesh as mesh_lib
from .cells import Cell, build_cell

HBM_BYTES = 80e9  # one H100 SXM

_VIEW_OPS = {"view", "_unsafe_view", "reshape"}
_UNEVEN = re.compile(r"not evenly divisible by mesh dimension (\d+)")
_GATHER_OPS = {"index", "gather", "embedding", "index_select"}
_FREE_OPS = {"empty", "empty_strided", "empty_like", "detach", "alias", "lift_fresh"}
_REGISTERED = False


def _shape(x) -> tuple:
    """The global shape of a strategy argument (a ``DTensorSpec``, or an
    ``OpStrategy`` where the installed DTensor passes one)."""
    if hasattr(x, "strategies"):
        x = x.strategies[0].output_spec
    return tuple(x.shape)


def _register_strategies():
    """Sharding strategies for the scatters, gathers and stacks of the
    cells, registered once.  DTensor has none for some of them and rules
    that differ between releases for others, so the dry run states its
    own, each one mesh dim's choices (DTensor takes the cheapest
    combination over the mesh):

    * a dim the op does not index keeps its sharding (self, values and
      the result alike), the index tensors replicated;
    * a gather (``index``) from a replicated source follows the
      sharding of its index;
    * a scatter of updates sharded along their entries into a target
      replicated over that mesh dim does not reach these rules: it runs
      as ``CostMode._scatter_partial``;
    * ``gather`` along a dim that is not sharded keeps the common
      sharding of its source and index (along a sharded one:
      ``CostMode._masked_gather``);
    * ``stack`` keeps a common sharding of its inputs;
    * ``searchsorted`` replicates its sorted sequence and keeps the
      placements of its queries;
    * replicated everywhere, always.

    An in-place op cannot change its target's placement, so there only
    the rules that keep it apply."""
    global _REGISTERED
    if _REGISTERED:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    aten = torch.ops.aten
    R = Replicate()

    @register_sharding(aten.searchsorted.Tensor)
    def _searchsorted(sorted_seq, values, **_kw):
        out = [([R], [R, R])]
        for d in range(len(_shape(values)) if len(_shape(sorted_seq)) == 1
                       else len(_shape(values)) - 1):
            out.append(([Shard(d)], [R, Shard(d)]))
        return out

    @register_sharding([aten.index_add.default, aten.index_add_.default])
    def _index_add(self, dim, index, source, alpha=1):
        nd = len(_shape(self))
        dim %= nd
        out = [([R], [R, None, R, R])]
        out += [([Shard(d)], [Shard(d), None, R, Shard(d)]) for d in range(nd) if d != dim]
        return out

    @register_sharding([aten.scatter_reduce.two, aten.scatter_reduce_.two])
    def _scatter_reduce(self, dim, index, src, reduce, include_self=True):
        nd = len(_shape(self))
        dim %= nd
        out = [([R], [R, None, R, R, None, None])]
        same = _shape(index) == _shape(src) == _shape(self)
        out += [([Shard(d)], [Shard(d), None, Shard(d), Shard(d), None, None])
                for d in range(nd) if d != dim and same]
        return out

    def _index_layout(self, indices):
        """(indexed dims, index tensors, where the indexed block lands in
        the result, the index broadcast's rank)."""
        idx_dims = [i for i, t in enumerate(indices) if t is not None]
        idx = [_shape(t) for t in indices if t is not None]
        b_nd = max(len(s) for s in idx)
        consecutive = idx_dims == list(range(idx_dims[0], idx_dims[-1] + 1))
        return idx_dims, idx, (idx_dims[0] if consecutive else 0), b_nd

    @register_sharding(aten.index.Tensor)
    def _index(self, indices):
        idx_dims, idx, at, b_nd = _index_layout(self, indices)
        n_i = len(idx)
        out = [([R], [R] * (1 + n_i))]
        for d in range(len(_shape(self))):
            if d in idx_dims:
                continue
            o = d if d < at else d + b_nd - sum(1 for i in idx_dims if d > i)
            out.append(([Shard(o)], [Shard(d)] + [R] * n_i))
        for bd in range(b_nd):
            pl = []
            for s in idx:
                off = b_nd - len(s)
                pl.append(Shard(bd - off) if bd >= off and s[bd - off] > 1 else R)
            if any(isinstance(p, Shard) for p in pl):
                out.append(([Shard(bd + at)], [R] + pl))
        return out

    @register_sharding([aten.index_put.default, aten.index_put_.default,
                        aten._index_put_impl_.default])
    def _index_put(self, indices, values, accumulate=False, *unsafe):
        idx_dims, idx, at, b_nd = _index_layout(self, indices)
        n_i, v_shape = len(idx), _shape(values)
        tail = [None] * (1 + len(unsafe))
        out = [([R], [R] + [R] * n_i + [R] + tail)]
        non_idx = [d for d in range(len(_shape(self))) if d not in idx_dims]
        for d in non_idx:
            o = d if d < at else d - len(idx_dims) + b_nd
            vd = o - (b_nd + len(non_idx) - len(v_shape))
            v = Shard(vd) if vd >= 0 and v_shape[vd] > 1 else R
            out.append(([Shard(d)], [Shard(d)] + [R] * n_i + [v] + tail))
        return out

    @register_sharding(aten.gather.default)
    def _gather(self, dim, index, sparse_grad=False):
        # along a sharded dim: ``CostMode._masked_gather``
        nd = len(_shape(self))
        dim %= nd
        return [([R], [R, None, R, None])] + [
            ([Shard(d)], [Shard(d), None, Shard(d), None]) for d in range(nd) if d != dim]

    @register_sharding(aten.stack.default)
    def _stack(tensors, dim=0):
        nd = len(_shape(tensors[0]))
        dim %= nd + 1
        out = [([R], [R] * len(tensors) + [None])]
        for d in range(nd):
            out.append(([Shard(d if d < dim else d + 1)], [Shard(d)] * len(tensors) + [None]))
        return out

    _REGISTERED = True


def _tensors(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_layout_error(e: Exception, view: bool = False) -> bool:
    """Whether ``e`` is DTensor finding no layout for an op (no sharding
    strategy, or none that fits its arguments), not a fault of the op.
    With ``view``, also a view's local shard that cannot take the shape
    DTensor gave it (a dim split across both mesh dims, which DTensor
    lays out without checking): the step's own shapes passed DTensor's
    propagation on the global ones first."""
    msg = str(e)
    return ((isinstance(e, NotImplementedError) and "sharding strategy" in msg)
            or (isinstance(e, RuntimeError) and "Sharding propagation failed" in msg)
            or (view and isinstance(e, RuntimeError) and "is invalid for input of size" in msg))


class CostMode(TorchDispatchMode):
    """Counts FLOPs and bytes of the ops that run on local tensors, and
    records collectives.  An op on DTensors is run by DTensor, which runs
    it as ops on the local shards that come back through this mode; ops
    on other tensor subclasses (the fake tensors of DTensor's sharding
    propagation) pass uncounted.

    A view that DTensor cannot lay out (a dim sharded unevenly for the
    new shape, as heads over ``model`` split into kv groups) is run
    after gathering the one mesh dim in its way, as the reference's SPMD
    partitioner reshards; each is counted in ``resharded`` by name, and
    the gather's bytes count as collectives like any other.  Any other
    op that DTensor cannot lay out, or lays out with a local shard that
    does not match its layout, raises: the cell fails."""

    def __init__(self, device_type: Optional[str] = "meta"):
        super().__init__()
        _register_strategies()
        self.device_type = device_type
        self.flops = 0
        self.bytes = 0
        self.collectives: List[hlo_analysis.Collective] = []
        self.resharded: Dict[str, int] = {}
        self.masked: Dict[str, int] = {}
        self._depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            if self._depth:
                return NotImplemented  # an op DTensor runs for an outer one
            if func._opname in _INDEX_OPS and _sharded_on_indexed(args[0], args[1]):
                return self._masked_local(func, args, kwargs)
            if func._opname == "gather" and _sharded_on_indexed(
                    args[0], [None] * (args[1] % args[0].ndim) + [args[2]]):
                return self._masked_gather(func, args, kwargs)
            plan = _scatter_plan(func, args, kwargs)
            if plan is not None:
                return self._scatter_partial(func, args, kwargs, plan)
            if func._opname == "_softmax" and _sharded_on_dim(args[0], args[1]):
                return self._sharded_softmax(func, args, kwargs)
            return self._on_dtensors(func, args, kwargs)
        out = func(*args, **kwargs)
        if any(t is not torch.Tensor and t is not torch.nn.Parameter for t in types):
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if self.device_type and any(t.device.type != self.device_type for t in ins + outs):
            return out  # DTensor's own host bookkeeping
        kind = hlo_analysis.kind_of(func)
        if kind is not None:
            self.collectives.append(hlo_analysis.Collective(
                func._opname, out, _group_ranks(args, kwargs)))
            return out
        if func._opname in _FREE_OPS or func.is_view:
            return out
        self.flops += _flops(func, args, kwargs, ins, outs, out)
        if func._opname in _GATHER_OPS:
            # a gather reads the rows it returns, not its whole source
            moved = 2 * sum(_nbytes(t) for t in outs) + sum(_nbytes(t) for t in ins[1:])
        else:
            moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.bytes += moved
        return out

    def _on_dtensors(self, func, args, kwargs):
        self._depth += 1
        try:
            with self:  # the local ops DTensor runs come back here
                counts = (self.flops, self.bytes, len(self.collectives))
                try:
                    out = func(*args, **kwargs)
                except Exception as e:  # noqa: BLE001 - re-raised unless a view's layout
                    if func._opname not in _VIEW_OPS or not _is_layout_error(e, view=True):
                        raise
                    # what the failed attempt ran does not count
                    self.flops, self.bytes = counts[:2]
                    del self.collectives[counts[2]:]
                    out = self._view(func, args, kwargs, e)
                    self.resharded[func._opname] = self.resharded.get(func._opname, 0) + 1
                bad = _inconsistent(out)
                if bad is not None:
                    raise RuntimeError(f"{func}: a local shard of {tuple(bad.to_local().shape)} "
                                       f"does not match its layout {bad.placements} of "
                                       f"{tuple(bad.shape)}")
                return out
        finally:
            self._depth -= 1

    def _masked_local(self, func, args, kwargs):
        """A gather or scatter at positions in a dim that ``self`` shards,
        as the reference's SPMD partitioner runs it.  ``self`` keeps its
        layout.  Over a mesh dim that shards an indexed dim, the indices
        and values are replicated, each rank shifts the indices into its
        block and masks those outside it, and a gather's result is summed
        over that mesh dim at once (the masked entries are zero).  Over a
        mesh dim that shards a dim the op does not index, the values and
        the result keep that shard.  Over the other mesh dims a gather
        follows its indices' shard, a scatter replicates them.  A scatter
        writes each rank's own block in place: exact where no two entries
        meet at one local position, as in the cells' writes (one slot a
        row).  The local ops are counted as any other."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        self._depth += 1
        try:
            with self:
                x, indices = args[0], list(args[1])
                mesh, pl = x.device_mesh, x.placements
                idx_dims = [d for d, t in enumerate(indices) if t is not None]
                b_shape = tuple(torch.broadcast_shapes(*(tuple(indices[d].shape)
                                                         for d in idx_dims)))
                consecutive = idx_dims == list(range(idx_dims[0], idx_dims[-1] + 1))
                at = idx_dims[0] if consecutive else 0
                n_out = x.ndim - len(idx_dims) + len(b_shape)
                gather = func._opname == "index"

                def out_dim(d):  # where a dim the op does not index lands
                    return d if d < at else d + len(b_shape) - sum(1 for i in idx_dims if d > i)

                first = indices[idx_dims[0]]
                idx_pl, out_pl = [], []
                for i, p in enumerate(pl):
                    q = first.placements[i] if isinstance(first, DTensor) else Replicate()
                    if isinstance(p, Shard):
                        idx_pl.append(Replicate())
                        out_pl.append(Partial() if p.dim in idx_dims else Shard(out_dim(p.dim)))
                    elif (gather and isinstance(q, Shard) and first.ndim == len(b_shape)
                          and b_shape[q.dim] > 1):
                        idx_pl.append(q)
                        out_pl.append(Shard(at + q.dim))
                    else:
                        idx_pl.append(Replicate())
                        out_pl.append(Replicate())
                local_shape, offset = compute_local_shape_and_global_offset(
                    tuple(x.shape), mesh, pl)
                mask, li = None, list(indices)
                for d in idx_dims:
                    t = indices[d]
                    if isinstance(t, DTensor):
                        t = t.redistribute(mesh, idx_pl).to_local()
                    t = t.long() - offset[d]
                    ok = (t >= 0) & (t < local_shape[d])
                    li[d] = torch.clamp(t, 0, local_shape[d] - 1)
                    mask = ok if mask is None else mask & ok
                mask = mask.reshape((1,) * at + tuple(mask.shape)
                                    + (1,) * (n_out - at - mask.ndim))
                local = x.to_local()
                if gather:
                    out = torch.where(mask, local[_as_key(li)], 0)
                    rest = [x.shape[d] for d in range(x.ndim) if d not in idx_dims]
                    shape = tuple(rest[:at]) + b_shape + tuple(rest[at:])
                    out = self._all_reduce(out, mesh, [i for i, p in enumerate(out_pl)
                                                       if p.is_partial()], "sum")
                    res = DTensor.from_local(out, mesh, [Replicate() if p.is_partial() else p
                                                         for p in out_pl],
                                             run_check=False, shape=shape,
                                             stride=_contiguous_stride(shape))
                else:
                    v = args[2]
                    if isinstance(v, DTensor):
                        v_pl = [Shard(p.dim - (n_out - v.ndim))
                                if isinstance(p, Shard) and p.dim >= n_out - v.ndim
                                and v.shape[p.dim - (n_out - v.ndim)] > 1 else Replicate()
                                for p in out_pl]
                        v = v.redistribute(mesh, v_pl).to_local()
                    accumulate = bool(args[3]) if len(args) > 3 else kwargs.get("accumulate", False)
                    new = torch.where(mask, v.to(local.dtype),
                                      0 if accumulate else local[_as_key(li)])
                    target = local if func._opname.endswith("_") else local.clone()
                    target.index_put_(tuple(li), new, accumulate=accumulate)
                    res = (x if target is local else
                           DTensor.from_local(target, mesh, pl, run_check=False,
                                              shape=x.shape, stride=x.stride()))
                self.masked[func._opname] = self.masked.get(func._opname, 0) + 1
                return res
        finally:
            self._depth -= 1

    def _masked_gather(self, func, args, kwargs):
        """``torch.gather`` along a dim that ``self`` shards (the loss's
        label logit from vocab-sharded logits), as ``_masked_local``: the
        index follows ``self``'s other shardings, each rank picks the
        entries in its block and the result is summed over the mesh dims
        that shard the gathered dim.  (DTensor's own masked partial for
        this gather does not survive the view that follows it.)"""
        from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        self._depth += 1
        try:
            with self:
                x, dim, index = args[0], args[1] % args[0].ndim, args[2]
                mesh, pl = x.device_mesh, x.placements
                idx_pl = [p if isinstance(p, Shard) and p.dim != dim else Replicate() for p in pl]
                out_pl = [Partial() if isinstance(p, Shard) and p.dim == dim else q
                          for p, q in zip(pl, idx_pl)]
                if isinstance(index, DTensor):
                    index = index.redistribute(mesh, idx_pl).to_local()
                local_shape, offset = compute_local_shape_and_global_offset(
                    tuple(x.shape), mesh, pl)
                li = index.long() - offset[dim]
                ok = (li >= 0) & (li < local_shape[dim])
                li = torch.clamp(li, 0, local_shape[dim] - 1)
                out = torch.where(ok, torch.gather(x.to_local(), dim, li), 0)
                shape = tuple(args[2].shape)
                self.masked["gather"] = self.masked.get("gather", 0) + 1
                out = self._all_reduce(out, mesh, [i for i, p in enumerate(out_pl)
                                                   if p.is_partial()], "sum")
                return DTensor.from_local(out, mesh, idx_pl, run_check=False, shape=shape,
                                          stride=_contiguous_stride(shape))
        finally:
            self._depth -= 1

    def _all_reduce(self, t, mesh, dims, how: str):
        """``t`` all-reduced (``how``: sum, max or min) over the mesh dims
        ``dims``: one collective over the whole world where they are every
        dim of a mesh that spans it, else one per mesh dim.  A boolean
        goes as ``uint8``."""
        from torch.distributed import _functional_collectives as funcol

        dtype = t.dtype
        if dtype == torch.bool:
            t = t.to(torch.uint8)
        if len(dims) == mesh.ndim and mesh.size() == dist.get_world_size():
            groups = [dist.group.WORLD]
        else:
            groups = [mesh.get_group(d) for d in dims]
        for g in groups:
            t = funcol.wait_tensor(funcol.all_reduce(t, how, g))
        return t.to(dtype)

    def _scatter_partial(self, func, args, kwargs, plan):
        """A scatter whose updates are sharded along their entries over a
        mesh dim that replicates its target: each rank scatters its own
        entries into a partial of the target, and one all-reduce over
        those mesh dims merges the partials (SUM, MAX or MIN, by
        ``plan.how``; a plain set as the sum of each rank's changes).
        Over a mesh dim that shards the target along a dim it does not
        index, the updates follow that shard and the indices are
        replicated.  The target keeps its layout; an in-place op writes
        its local block."""
        from torch.distributed.tensor import DTensor

        self._depth += 1
        try:
            with self:
                x = args[0]
                mesh = x.device_mesh
                new = list(args)
                for pos, pl in plan.moves:
                    a = new[pos]
                    if isinstance(a, (list, tuple)):
                        new[pos] = [t if t is None or p is None else _local_as(t, mesh, p)
                                    for t, p in zip(a, pl)]
                    else:
                        new[pos] = _local_as(a, mesh, pl)
                local = x.to_local()
                if func._opname == "_index_put_impl_":
                    op, new = torch.ops.aten.index_put.default, new[:4]
                else:
                    op = getattr(getattr(torch.ops.aten, func._opname.rstrip("_")),
                                 func._overloadname)
                if plan.how == "set":
                    idx = new[1]
                    delta = torch.as_tensor(new[2], device=local.device).to(local.dtype) \
                        - local[_as_key(idx)]
                    part = torch.zeros_like(local).index_put_(tuple(idx), delta)
                elif plan.how == "sum":
                    part = op(torch.zeros_like(local), *new[1:], **kwargs)
                else:
                    part = op(local.clone(), *new[1:], **kwargs)
                merged = self._all_reduce(part, mesh, plan.dims,
                                          "sum" if plan.how == "set" else plan.how)
                res = local + merged if plan.how in ("sum", "set") else merged
                self.masked["scatter_partial"] = self.masked.get("scatter_partial", 0) + 1
                if func._opname.endswith("_"):
                    local.copy_(res)
                    return x
                return DTensor.from_local(res, mesh, x.placements, run_check=False,
                                          shape=x.shape, stride=x.stride())
        finally:
            self._depth -= 1

    def _sharded_softmax(self, func, args, kwargs):
        """``_softmax`` over a dim that some mesh dims shard: a local max,
        an all-reduce MAX of it, the local sum of the exponentials and an
        all-reduce SUM of the sums over those mesh dims.  The output keeps
        the input's layout."""
        from torch.distributed.tensor import DTensor, Shard

        self._depth += 1
        try:
            with self:
                x, dim = args[0], args[1] % args[0].ndim
                mesh = x.device_mesh
                dims = [i for i, p in enumerate(x.placements)
                        if isinstance(p, Shard) and p.dim == dim]
                local = x.to_local()
                if len(args) > 2 and args[2]:
                    local = local.float()
                m = self._all_reduce(local.amax(dim, keepdim=True), mesh, dims, "max")
                m = torch.where(torch.isfinite(m), m, 0.0)
                e = torch.exp(local - m)
                s = self._all_reduce(e.sum(dim, keepdim=True), mesh, dims, "sum")
                out = e / s
                return DTensor.from_local(out, mesh, x.placements, run_check=False,
                                          shape=x.shape, stride=_contiguous_stride(x.shape))
        finally:
            self._depth -= 1

    def _view(self, func, args, kwargs, err):
        """A view DTensor refuses: gather the mesh dim DTensor names, else
        the innermost one still sharded, and try again while the error is
        one of layout."""
        from torch.distributed.tensor import Replicate

        x = args[0]
        for _ in range(x.device_mesh.ndim):
            pl = list(x.placements)
            m = _UNEVEN.search(str(err))
            sharded = [i for i, p in enumerate(pl) if not p.is_replicate()]
            if m is None and not sharded:
                raise err
            pl[int(m.group(1)) if m else sharded[-1]] = Replicate()
            x = x.redistribute(x.device_mesh, pl)
            try:
                return func(x, *args[1:], **kwargs)
            except Exception as e:  # noqa: BLE001
                if not _is_layout_error(e, view=True):
                    raise
                err = e
        raise err


def _as_key(indices) -> tuple:
    """An ``aten.index`` index list as a Python subscript (None selects
    the whole dim)."""
    return tuple(slice(None) if t is None else t for t in indices)


_INDEX_OPS = {"index", "index_put", "index_put_", "_index_put_impl_"}


def _sharded_on_indexed(x, indices) -> bool:
    """Whether the DTensor ``x`` is sharded on a dim that ``indices`` (an
    ``index``/``index_put`` index list) indexes."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return False
    idx_dims = {i for i, t in enumerate(indices) if t is not None}
    return any(isinstance(p, Shard) and p.dim in idx_dims for p in x.placements)


def _sharded_on_dim(x, dim) -> bool:
    """Whether the DTensor ``x`` is sharded along its dim ``dim``."""
    from torch.distributed.tensor import DTensor, Shard

    if not isinstance(x, DTensor):
        return False
    dim %= x.ndim
    return any(isinstance(p, Shard) and p.dim == dim for p in x.placements)


def _local_as(t, mesh, placements):
    """The local block of ``t`` under ``placements`` (a plain tensor is
    a replicated constant: it is returned as it is where every placement
    replicates, else made a DTensor first)."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(t, DTensor):
        if all(p.is_replicate() for p in placements):
            return t
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)
    return t.redistribute(mesh, placements).to_local()


class _ScatterPlan(NamedTuple):
    how: str  # sum | max | min | set
    dims: tuple  # the mesh dims whose partials one all-reduce merges
    moves: tuple  # (argument position, its placements: a list for index lists)


_SCATTER_OPS = {"index_put", "index_put_", "_index_put_impl_", "index_add", "index_add_",
                "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_"}
_REDUCE_HOW = {"sum": "sum", "amax": "max", "amin": "min"}


def _scatter_plan(func, args, kwargs) -> Optional[_ScatterPlan]:
    """How ``_scatter_partial`` lays out a scatter, or None where it does
    not apply: the target is a DTensor sharded only along dims the
    scatter does not index, and on some mesh dim that replicates it an
    index is sharded (its updates lie spread over that mesh dim)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    name = func._opname
    if name not in _SCATTER_OPS or not isinstance(args[0], DTensor):
        return None
    x = args[0]
    nd = x.ndim
    R = Replicate()
    if name.lstrip("_").startswith("index_put"):
        indices = list(args[1])
        idx_dims = [d for d, t in enumerate(indices) if t is not None]
        accumulate = bool(args[3]) if len(args) > 3 else kwargs.get("accumulate", False)
        how = "sum" if accumulate else ("max" if x.dtype == torch.bool else "set")
        b_shape = tuple(torch.broadcast_shapes(*(tuple(indices[d].shape) for d in idx_dims)))
        b_nd = len(b_shape)
        consecutive = idx_dims == list(range(idx_dims[0], idx_dims[-1] + 1))
        at = idx_dims[0] if consecutive else 0
        n_out = nd - len(idx_dims) + b_nd
        vals = args[2]
        v_nd = vals.ndim if isinstance(vals, torch.Tensor) else 0

        def out_dim(d):
            return d if d < at else d + b_nd - sum(1 for i in idx_dims if d > i)

        def plan_dim(i, p):
            """(index placements, value placement, partial?) on mesh dim i."""
            if isinstance(p, Shard):
                vd = out_dim(p.dim) - (n_out - v_nd)
                v = Shard(vd) if vd >= 0 and vals.shape[vd] > 1 else R
                return [R if indices[d] is not None else None for d in range(len(indices))], v, False
            bd = None
            for d in idx_dims:
                t = indices[d]
                q = t.placements[i] if isinstance(t, DTensor) else R
                if isinstance(q, Shard) and t.shape[q.dim] > 1:
                    bd = q.dim + b_nd - t.ndim
                    break
            if bd is None:
                return [R if indices[d] is not None else None for d in range(len(indices))], R, False
            ipl = []
            for d in range(len(indices)):
                t = indices[d]
                if t is None:
                    ipl.append(None)
                    continue
                k = bd - (b_nd - t.ndim)
                ipl.append(Shard(k) if k >= 0 and t.shape[k] > 1 else R)
            vd = at + bd - (n_out - v_nd)
            v = Shard(vd) if vd >= 0 and vals.shape[vd] > 1 else R
            return ipl, v, True

        per = [plan_dim(i, p) for i, p in enumerate(x.placements)]
        if any(isinstance(p, Shard) and p.dim in idx_dims for p in x.placements):
            return None
        moves = ((1, [[pl[0][d] for pl in per] if indices[d] is not None else None
                      for d in range(len(indices))]),)
        if isinstance(vals, torch.Tensor):
            moves += ((2, [pl[1] for pl in per]),)
    else:
        dim = args[1] % nd
        index, src = args[2], args[3]
        if name.startswith("scatter_reduce"):
            include_self = args[5] if len(args) > 5 else kwargs.get("include_self", True)
            how = _REDUCE_HOW.get(args[4])
            if how is None or not include_self:
                return None
        else:
            how = "sum"
        if not isinstance(index, DTensor) or _sharded_on_dim(x, dim):
            return None
        per = []
        for i, p in enumerate(x.placements):
            q = index.placements[i]
            if isinstance(p, Shard):
                per.append((R if name.startswith("index_add") else p, p, False))
            elif isinstance(q, Shard) and q.dim == (0 if name.startswith("index_add") else dim):
                # the index sharded along its entries (a scatter's index
                # sharded along another dim follows the target's rows:
                # DTensor's own layout)
                per.append((q, Shard(dim) if name.startswith("index_add") else q, True))
            else:
                per.append((R, R, False))
        moves = ((2, [pl[0] for pl in per]), (3, [pl[1] for pl in per]))
    if any(not (p.is_replicate() or isinstance(p, Shard)) for p in x.placements):
        return None
    dims = tuple(i for i, pl in enumerate(per) if pl[2])
    if not dims:
        return None
    return _ScatterPlan(how, dims, moves)


# pointwise ops XLA counts as transcendentals, not FLOPs
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "sin", "cos",
                   "tan", "tanh", "sigmoid", "erf", "erfc", "erfinv", "pow", "sqrt", "rsqrt",
                   "atan2", "silu", "gelu", "softplus", "logit", "reciprocal"}
_NO_FLOPS = {"clone", "copy", "fill", "zero", "lift_fresh_copy"}
_COMBINING_SCATTERS = {"index_add", "scatter_add", "scatter_reduce", "index_put",
                       "_index_put_impl"}


def _flops(func, args, kwargs, ins, outs, out) -> int:
    """The op's FLOPs as XLA's cost analysis counts them (module
    docstring)."""
    packet = func._overloadpacket
    if packet in flop_registry:
        return int(flop_registry[packet](*args, **kwargs, out_val=out))
    base = func._opname.rstrip("_")
    if base in _NO_FLOPS or base in _TRANSCENDENTAL:
        return 0
    if torch.Tag.pointwise in func.tags or base == "_to_copy":
        return sum(t.numel() for t in outs[:1])
    if torch.Tag.reduction in func.tags:
        return ins[0].numel() if ins else 0
    if base in ("_softmax", "_log_softmax"):
        return 4 * (outs[0].numel() if outs else 0)  # max, subtract, sum, divide
    if base in ("cumsum", "cumprod", "cummax", "cummin"):
        return ins[0].numel() if ins else 0
    if base in _COMBINING_SCATTERS:
        if base.startswith("index_put") or base == "_index_put_impl":
            if not (bool(args[3]) if len(args) > 3 else kwargs.get("accumulate", False)):
                return 0
            idx = [(d, t) for d, t in enumerate(args[1]) if t is not None]
            entries = int(np.prod(torch.broadcast_shapes(*(tuple(t.shape) for _, t in idx)),
                                  dtype=np.int64))
            indexed = int(np.prod([args[0].shape[d] for d, _ in idx], dtype=np.int64))
            return entries * (args[0].numel() // max(indexed, 1))
        src = args[3] if len(args) > 3 and isinstance(args[3], torch.Tensor) else None
        return src.numel() if src is not None else 0
    return 0


def _local_shape(x) -> tuple:
    """Rank 0's shard shape of the DTensor ``x`` under its placements."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    return tuple(compute_local_shape_and_global_offset(tuple(x.shape), x.device_mesh,
                                                       x.placements)[0])


def _inconsistent(out):
    """The first output DTensor whose local shard is not the shape its
    layout gives (a sharding rule of the installed DTensor that got the
    layout wrong), else None."""
    from torch.distributed.tensor import DTensor

    for t in _tensors(out):
        if isinstance(t, DTensor) and tuple(t.to_local().shape) != _local_shape(t):
            return t
    return None


def _group_ranks(args, kwargs) -> tuple:
    """Global ranks of a functional collective's group (its ``group_name``
    argument, the last string among the arguments)."""
    names = [a for a in list(args) + list(kwargs.values()) if isinstance(a, str)]
    if not names:
        return ()
    from torch.distributed.distributed_c10d import _resolve_process_group

    return tuple(dist.get_process_group_ranks(_resolve_process_group(names[-1])))


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of ``world_size`` ranks on the ``fake``
    backend, this process being rank 0; destroyed on exit.  Collectives
    on it return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(int(s), 1)
    return tuple(reversed(stride))


def distribute(tree, specs, mesh, spmd=None):
    """``tree``'s meta tensors as DTensors on ``spmd`` (default ``mesh``),
    each local shard a meta tensor of rank 0's shape under its spec."""
    from torch.distributed.tensor import DTensor

    spmd = mesh if spmd is None else spmd

    def one(spec, t):
        local = torch.empty(SH.local_shape(t.shape, spec, mesh), dtype=t.dtype, device="meta")
        return DTensor.from_local(local, spmd, SH.placements(spmd, spec), run_check=False,
                                  shape=t.shape, stride=_contiguous_stride(t.shape))

    return SH.map_specs(one, specs, tree)


def _redistribute(tree, specs, mesh):
    from torch.distributed.tensor import DTensor

    def one(spec, t):
        if isinstance(t, DTensor):
            return t.redistribute(mesh, SH.placements(mesh, spec))
        return t

    return SH.map_specs(one, specs, tree)


def local_arg_bytes(cell: Cell, mesh) -> int:
    """Bytes of rank 0's shards of the cell's arguments."""
    total = 0

    def one(spec, t):
        nonlocal total
        local = SH.local_shape(t.shape, spec, mesh)
        total += int(np.prod(local, dtype=np.int64)) * t.element_size()

    SH.map_specs(one, cell.in_specs, cell.args)
    return total


def _step(cell: Cell, mesh):
    """The cell's step as DTensors see it.  The shard-local stream
    update (``variant="shardmap"``) runs under ``local_map`` with its
    specs' placements: each rank merges into its own rows, the
    counterpart of the reference's ``shard_map``."""
    if cell.meta.get("variant") != "shardmap":
        return cell.step_fn
    from torch.distributed.tensor.experimental import local_map

    pool_specs, batch_spec = cell.in_specs
    # one entry per flattened leaf: data, n, lo and the absent value lane
    pool_pl = tuple(SH.placements(mesh, s) for s in pool_specs[:3]) + (None,)
    return local_map(cell.step_fn, out_placements=pool_pl,
                     in_placements=pool_pl + (SH.placements(mesh, batch_spec),),
                     device_mesh=mesh)


@contextlib.contextmanager
def attention_on_local_shards():
    """While open, ``models.layers``' blockwise attention runs under
    ``local_map`` when given DTensors: each rank runs the block loop on
    its own shards of q, k and v, as the reference's attention runs
    inside its SPMD program, with the reference's placements.  A mesh dim
    that shards the batch of q, k and v alike, or their heads where it
    divides both the query and the kv heads (a rank's query heads then
    fall on its own kv heads), keeps its shards; any other is gathered
    first (the sequence always is).  Run op by op on DTensors the loop
    would take ~10 dispatches per block step (minutes a layer at 32k
    tokens), and its layout would follow the installed DTensor's
    choices."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from ..models import layers

    plain = layers._blockwise_attention

    def on_shards(q, k, v, cfg, scale, triangular):
        if not isinstance(q, DTensor):
            return plain(q, k, v, cfg, scale, triangular)
        mesh = q.device_mesh
        pq, pkv, heads = [], [], 1
        for i, (a, b, c) in enumerate(zip(q.placements, k.placements, v.placements)):
            n = mesh.size(i)
            keep = (isinstance(a, Shard) and a == b == c
                    and ((a.dim == 0 and q.shape[0] % n == 0)
                         or (a.dim == 2 and cfg.n_heads % (heads * n) == 0
                             and cfg.n_kv_heads % (heads * n) == 0)))
            heads *= n if keep and a.dim == 2 else 1
            pq.append(a if keep else Replicate())
            pkv.append(b if keep else Replicate())
        local_cfg = dataclasses.replace(cfg, n_heads=cfg.n_heads // heads,
                                        n_kv_heads=cfg.n_kv_heads // heads)

        def block(q_l, k_l, v_l):
            return plain(q_l, k_l, v_l, local_cfg, scale, triangular)

        return local_map(block, out_placements=pq, in_placements=(pq, pkv, pkv),
                         device_mesh=mesh, redistribute_inputs=True)(q, k, v)

    layers._blockwise_attention = on_shards
    try:
        yield
    finally:
        layers._blockwise_attention = plain


def measure(cell: Cell, mesh) -> Dict[str, object]:
    """Run ``cell`` on ``mesh`` (its DTensors on ``mesh.spmd_mesh``) and
    count its per-device costs."""
    from torch.distributed.tensor.experimental import implicit_replication

    spmd = mesh_lib.spmd_mesh(mesh)
    args = distribute(cell.args, cell.in_specs, mesh, spmd)
    t0 = time.time()
    # a plain tensor the step makes itself (an arange, a mask) is a
    # replicated constant, as in the reference's SPMD program
    with implicit_replication(), attention_on_local_shards(), CostMode() as cm:
        out = _step(cell, spmd)(*args)
        if cell.out_specs is not None:
            _redistribute(out, cell.out_specs, spmd)
    run_s = time.time() - t0
    coll_total, coll_kinds = hlo_analysis.collective_bytes(cm.collectives)
    links = hlo_analysis.bytes_by_link(cm.collectives)
    return {"flops": float(cm.flops), "bytes": float(cm.bytes), "coll": float(coll_total),
            "kinds": coll_kinds, "links": links, "resharded": dict(cm.resharded),
            "masked": dict(cm.masked),
            "run_s": run_s}


def run_cell(arch: str, shape: str, multi_pod: bool, reduced: bool = False,
             host: bool = False, **build_kw) -> dict:
    """Build ``arch``/``shape`` at full width (REDUCED with ``reduced``) on
    the 256-rank (or 512-rank) fake mesh, or with ``host`` on the 1x1
    mesh, run its step and report the reference's dry-run keys."""
    n_chips = 1 if host else 512 if multi_pod else 256
    with fake_world(n_chips):
        mesh = (mesh_lib.make_host_mesh() if host
                else mesh_lib.make_production_mesh(multi_pod=multi_pod))
        t0 = time.time()
        cell = build_cell(arch, shape, mesh, reduced=reduced, **build_kw)
        build_s = time.time() - t0
        c = measure(cell, mesh)
        arg_bytes = local_arg_bytes(cell, mesh)

    compute_s = c["flops"] / mesh_lib.PEAK_FLOPS_BF16
    memory_s = c["bytes"] / mesh_lib.HBM_BW
    collective_s = (c["links"]["nvlink"] / mesh_lib.NVLINK_BW
                    + c["links"]["network"] / mesh_lib.NET_BW)
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    model_flops = cell.meta.get("model_flops", 0.0)
    useful = model_flops / (n_chips * c["flops"]) if c["flops"] else 0.0
    mem_model = cell.meta.get("mem_model")
    mem_total = mem_model["total"] if mem_model else float(arg_bytes)
    return {
        "arch": arch,
        "shape": shape,
        "mesh": "1x1" if host else "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "ok": True,
        "reduced": reduced,
        "build_s": round(build_s, 2),
        "run_s": round(c["run_s"], 2),
        "flops_per_dev": c["flops"],
        "bytes_per_dev": c["bytes"],
        "collective_bytes_per_dev": c["coll"],
        "collective_kinds": c["kinds"],
        "collective_links": c["links"],
        "resharded_views": c["resharded"],
        "masked_local_ops": c["masked"],
        "compute_s_term": compute_s,
        "memory_s_term": memory_s,
        "collective_s_term": collective_s,
        "dominant": dominant.replace("_s", ""),
        "model_flops": model_flops,
        "useful_compute_frac": useful,
        "mem_argument_bytes": arg_bytes,
        "mem_model": mem_model,
        "fits": bool(mem_total <= HBM_BYTES),
        "fits_by": "mem_model" if mem_model else "mem_argument_bytes",
        "meta": {k: v for k, v in cell.meta.items() if isinstance(v, (int, float, str, bool))},
    }


def _ok_line(tag: str, res: dict) -> str:
    mem = res["mem_model"]["total"] if res["mem_model"] else res["mem_argument_bytes"]
    return (f"[OK] {tag}: run={res['run_s']}s dominant={res['dominant']} "
            f"terms(c/m/x)=({res['compute_s_term']:.2e},"
            f"{res['memory_s_term']:.2e},{res['collective_s_term']:.2e}) "
            f"mem={mem / 2**30:.2f}GiB/dev fits={res['fits']} "
            f"useful={res['useful_compute_frac']:.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="run every assigned cell")
    ap.add_argument("--include-stream", action="store_true")
    ap.add_argument("--reduced", action="store_true", help="the REDUCED configs")
    ap.add_argument("--out", default=None, help="append JSON lines here")
    args = ap.parse_args(argv)

    if args.all:
        cells = list(registry.all_cells(include_stream=args.include_stream))
    else:
        if not args.arch:
            ap.error("--arch required unless --all")
        spec = registry.get(args.arch)
        shapes = [args.shape] if args.shape else list(spec.shapes)
        cells = [(args.arch, s) for s in shapes]

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}/{shape}/{'2x16x16' if mp else '16x16'}"
            try:
                res = run_cell(arch, shape, mp, reduced=args.reduced)
                print(_ok_line(tag, res), flush=True)
            except Exception as e:  # noqa: BLE001 - report and continue
                failures += 1
                res = {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if mp else "16x16",
                       "ok": False, "error": f"{type(e).__name__}: {e}"}
                print(f"[FAIL] {tag}: {type(e).__name__}: {str(e)[:300]}", flush=True)
                traceback.print_exc(file=sys.stderr)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(res) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
