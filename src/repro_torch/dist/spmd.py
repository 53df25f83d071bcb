"""SPMD layouts on DTensors: the program GSPMD makes of the reference's
cells, run with real values on real ranks, or counted on meta tensors
by the dry run (``launch.dryrun.CostMode`` is ``SpmdMode`` plus
counting, so the dry run counts the program the ranks run).

The reference jits each cell with partition specs and lets XLA's SPMD
partitioner lay out every op on a ``("data", "model")`` mesh.  Here the
arguments are DTensors laid out by the same specs (``distribute``, the
rules of ``dist.shardings``), the step runs eagerly, and DTensor lays
out each op.  Where DTensor has no layout for an op of the cells, or one
that differs between its releases, this module states its own in the
manner of the reference's SPMD partitioner, and never replicates
quietly:

  * the scatters, gathers and stacks of the cells take the strategies of
    ``register_strategies``;
  * a gather or scatter at positions in a dim the operand shards runs
    masked on each rank's block (``SpmdMode._masked_local`` and
    ``_masked_gather``): the vocab-sharded embedding lookups of the LMs
    and of DCN-v2, their gradients' scatters, the loss's label logit and
    the write of a new key into a sequence-sharded cache;
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
    scores are never gathered (``_sharded_softmax``);
  * the blockwise attention runs under ``local_map`` on each rank's
    batch and head shards (``attention_on_local_shards``), and so does
    the flash-decode kernel on a cache sharded on its kv heads
    (``flash_decode_on_local_shards``: row 12 launches on each rank's
    heads), and on a cache sharded on the sequence, where each rank's
    launch returns its log-sum-exp and the ranks combine their partial
    outputs in two all-reduces; ``models.layers`` routes DTensors to both;
  * a view DTensor cannot lay out (heads over ``model`` split into kv
    groups where the kv heads do not divide the axis) gathers the one
    mesh dim in its way and tries again (``SpmdMode._view``).

Any other op DTensor cannot lay out, or lays out with a local shard that
does not match its layout, raises.

Collectives: DTensor issues functional collectives (``all_reduce``,
``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``, ``shard_dim_alltoall``).  Gloo runs some of them
on CPU tensors only, so where a CUDA tensor meets a gloo group the mode
runs the collective on host copies and moves the result back
(``HOST_COPIED`` counts these calls by name, and so does each mode's
``host_copied``); NCCL and CPU tensors take the collective as it is.
Every collective is recorded (``SpmdMode.collectives``, a
``dist.collectives.Collective`` by its result's shape on this rank) for
``launch.hlo_analysis``.

``running()`` opens what a step on DTensors needs (the mode and
``implicit_replication`` for the plain tensors a step makes itself);
``distribute`` lays a tree out by a spec
tree, ``from_local`` wraps this rank's slices (``shardings.place``) as
DTensors, ``to_local`` and ``undistribute`` go back.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import re
from typing import Dict, List, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils._python_dispatch import TorchDispatchMode

from . import shardings as SH
from .collectives import Collective, kind_of

_VIEW_OPS = {"view", "_unsafe_view", "reshape"}
_UNEVEN = re.compile(r"not evenly divisible by mesh dimension (\d+)")
_REGISTERED = False
# collectives run through host memory (a CUDA tensor on a gloo group), by name
HOST_COPIED: Dict[str, int] = collections.Counter()


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def _shape(x) -> tuple:
    """The global shape of a strategy argument (a ``DTensorSpec``, or an
    ``OpStrategy`` where the installed DTensor passes one)."""
    if hasattr(x, "strategies"):
        x = x.strategies[0].output_spec
    return tuple(x.shape)


def register_strategies():
    """Sharding strategies for the scatters, gathers and stacks of the
    cells, registered once.  DTensor has none for some of them and rules
    that differ between releases for others, so this module states its
    own, each one mesh dim's choices (DTensor takes the cheapest
    combination over the mesh):

    * a dim the op does not index keeps its sharding (self, values and
      the result alike), the index tensors replicated;
    * a gather (``index``) from a replicated source follows the
      sharding of its index;
    * a scatter of updates sharded along their entries into a target
      replicated over that mesh dim does not reach these rules: it runs
      as ``SpmdMode._scatter_partial``;
    * ``gather`` along a dim that is not sharded keeps the common
      sharding of its source and index (along a sharded one:
      ``SpmdMode._masked_gather``);
    * ``stack`` keeps a common sharding of its inputs;
    * ``searchsorted`` replicates its sorted sequence and keeps the
      placements of its queries;
    * replicated everywhere, always.

    An in-place op cannot change its target's placement, so there only
    the rules that keep it apply."""
    global _REGISTERED
    if _REGISTERED:
        return
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
        # along a sharded dim: ``SpmdMode._masked_gather``
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


def _group_backend(group_name: str) -> str:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return dist.get_backend(_resolve_process_group(group_name))


def _host_copy(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_host_copy(t) for t in x)
    return x


def _as_meta(x):
    """``x``'s shape and dtype on the meta device: what a record of a
    collective keeps (the bytes it moved, not the values)."""
    if isinstance(x, torch.Tensor):
        return torch.empty_like(x, device="meta")
    if isinstance(x, (list, tuple)):
        return [_as_meta(t) for t in x]
    return x


class SpmdMode(TorchDispatchMode):
    """Runs ops on DTensors with the layouts of the module docstring.
    An op on DTensors is run by DTensor, which runs it as ops on the
    local shards that come back through this mode (``_local``); ops on
    other tensor subclasses (the fake tensors of DTensor's sharding
    propagation) pass as they are.

    A view that DTensor cannot lay out (a dim sharded unevenly for the
    new shape, as heads over ``model`` split into kv groups) is run
    after gathering the one mesh dim in its way, as the reference's SPMD
    partitioner reshards; each is counted in ``resharded`` by name, and
    the gather is a collective like any other.  Any other op that
    DTensor cannot lay out, or lays out with a local shard that does not
    match its layout, raises.

    ``device_type``: where set, the ops and collectives of the run are
    those on tensors of that device type (the dry run's ``meta``); the
    rest are DTensor's own host bookkeeping."""

    def __init__(self, device_type: Optional[str] = None):
        super().__init__()
        register_strategies()
        self.device_type = device_type
        self.collectives: list = []
        self.resharded: Dict[str, int] = {}
        self.masked: Dict[str, int] = {}
        self.host_copied: Dict[str, int] = {}
        self._depth = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}

        if any(issubclass(t, DTensor) for t in types):
            if self._depth:
                return NotImplemented  # an op DTensor runs for an outer one
            args, kwargs = self._reduce_integer_partials(args, kwargs)
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
        return self._local(func, types, args, kwargs)

    def _local(self, func, types, args, kwargs):
        """An op on local tensors: run it (a collective through host
        memory where a CUDA tensor meets a gloo group) and record the
        collectives of the run."""
        kind = kind_of(func)
        if kind is not None and self._via_host(args, kwargs):
            out = self._host_collective(func, args, kwargs)
        else:
            out = func(*args, **kwargs)
        if any(t is not torch.Tensor and t is not torch.nn.Parameter for t in types):
            return out
        if kind is None:
            self._count(func, args, kwargs, out)
        elif self._of_the_run(_tensors((args, kwargs)) + _tensors(out)):
            self.collectives.append(Collective(
                func._opname, _as_meta(out), _group_ranks(args, kwargs)))
        return out

    def _of_the_run(self, tensors) -> bool:
        """Whether an op on ``tensors`` is the run's, not DTensor's own
        host bookkeeping (with ``device_type`` set)."""
        return not self.device_type or all(t.device.type == self.device_type for t in tensors)

    def _count(self, func, args, kwargs, out) -> None:
        """A local op that moves nothing between ranks (the dry run counts
        its FLOPs and bytes)."""

    @staticmethod
    def _via_host(args, kwargs) -> bool:
        """Whether a collective's tensors are CUDA tensors on a gloo group."""
        names = [a for a in list(args) + list(kwargs.values()) if isinstance(a, str)]
        if not names or not any(t.is_cuda for t in _tensors((args, kwargs))):
            return False
        try:
            return _group_backend(names[-1]) == "gloo"
        except (KeyError, ValueError, RuntimeError):
            return False

    def _host_collective(self, func, args, kwargs):
        """The collective on host copies of its tensors, waited for, its
        result moved back to the tensors' device (into the input for an
        in-place one)."""
        dev = next(t.device for t in _tensors((args, kwargs)) if t.is_cuda)
        out = func(*_host_copy(list(args)), **{k: _host_copy(v) for k, v in kwargs.items()})
        wait = torch.ops._c10d_functional.wait_tensor.default
        name = func._opname
        self.host_copied[name] = self.host_copied.get(name, 0) + 1
        HOST_COPIED[name] += 1
        if isinstance(out, (list, tuple)):
            res = [wait(t).to(dev) for t in out]
            if name.endswith("_"):
                for t, r in zip(args[0], res):
                    t.copy_(r)
                return args[0]
            return res
        res = wait(out).to(dev)
        if name.endswith("_"):
            return args[0].copy_(res)
        return res

    def _reduce_integer_partials(self, args, kwargs):
        """Every integer or boolean operand that is a pending sum over some
        mesh dims (``Partial``, a count summed over sharded entries)
        all-reduced first: beside it DTensor would lay a replicated
        integer operand out as a partial by dividing it over the ranks,
        which truncates (F6: ``n + keep.sum()`` lost up to a rank's
        remainder)."""

        def pending(a):
            return (isinstance(a, DTensor) and not a.dtype.is_floating_point
                    and not a.dtype.is_complex and any(p.is_partial() for p in a.placements))

        if not any(pending(a) for a in _tensors((args, kwargs))):
            return args, kwargs

        def fix(a):
            if isinstance(a, (list, tuple)):
                return type(a)(fix(x) for x in a)
            if not pending(a):
                return a
            return a.redistribute(a.device_mesh, [Replicate() if p.is_partial() else p
                                                  for p in a.placements])

        self._depth += 1
        try:
            with self:  # the all-reduces run and are recorded as the run's
                return fix(args), {k: fix(v) for k, v in kwargs.items()}
        finally:
            self._depth -= 1

    def _on_dtensors(self, func, args, kwargs):
        self._depth += 1
        try:
            with self:  # the local ops DTensor runs come back here
                mark = self._mark()
                try:
                    out = func(*args, **kwargs)
                except Exception as e:  # noqa: BLE001 - re-raised unless a view's layout
                    if func._opname not in _VIEW_OPS or not _is_layout_error(e, view=True):
                        raise
                    # what the failed attempt ran does not count
                    self._rewind(mark)
                    out = self._view(func, args, kwargs, e)
                    self.resharded[func._opname] = self.resharded.get(func._opname, 0) + 1
        finally:
            self._depth -= 1
        # outside the mode: the layout's shape arithmetic is not the step's
        bad = _inconsistent(out)
        if bad is not None:
            raise RuntimeError(f"{func}: a local shard of {tuple(bad.to_local().shape)} "
                               f"does not match its layout {bad.placements} of "
                               f"{tuple(bad.shape)}")
        return out

    def _mark(self):
        """What the run has recorded so far (``_rewind`` returns to it)."""
        return len(self.collectives)

    def _rewind(self, mark) -> None:
        del self.collectives[mark:]

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
        meet at one position, as in the cells' writes (one slot a row).  A
        set moves each entry outside the block onto an entry inside it
        (``_onto_an_entry_in_block``; GSPMD's scatter drops such an entry),
        with the same ops on real and meta tensors, so the dry run counts
        what the ranks run.  The local ops run through this mode as any other."""
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
                mask_b = mask
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
                    if not accumulate and mask_b.ndim:
                        li, new = _onto_an_entry_in_block(li, idx_dims, new, mask, mask_b, at)
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
        dim of a mesh that spans it, else one per mesh dim of more than
        one rank (over one rank the all-reduce is ``t`` itself).  A
        boolean goes as ``uint8``."""
        from torch.distributed import _functional_collectives as funcol

        dims = [d for d in dims if mesh.size(d) > 1]
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


def _onto_an_entry_in_block(li, idx_dims, new, mask, mask_b, at):
    """A masked set's clamped indices and values with every entry outside
    the block moved onto the block's first entry, index and value alike
    (where no entry lies in the block, onto entry 0, which writes back
    the old value at its clamped index).  An entry outside the block left
    clamped onto the block's edge would meet an entry of the block there
    with another value, and either could win; a repeat of one entry
    writes what it writes.  Fixed shapes, no host sync: the same ops on
    real and meta tensors.  ``mask`` is ``mask_b`` (over the index
    broadcast's shape) laid over the values' dims from ``at``."""
    b_shape = tuple(mask_b.shape)
    first = mask_b.reshape(-1).to(torch.int32).argmax().reshape(1)
    idx = list(li)
    for d in idx_dims:
        t = li[d].expand(b_shape)
        idx[d] = torch.where(mask_b, t, t.reshape(-1).index_select(0, first).reshape(
            (1,) * len(b_shape)))
    flat = new.flatten(at, at + len(b_shape) - 1)
    at_first = flat.index_select(at, first).reshape(
        new.shape[:at] + (1,) * len(b_shape) + new.shape[at + len(b_shape):])
    return idx, torch.where(mask, new, at_first)


def _as_key(indices) -> tuple:
    """An ``aten.index`` index list as a Python subscript (None selects
    the whole dim)."""
    return tuple(slice(None) if t is None else t for t in indices)


_INDEX_OPS = {"index", "index_put", "index_put_", "_index_put_impl_"}


def _sharded_on_indexed(x, indices) -> bool:
    """Whether the DTensor ``x`` is sharded on a dim that ``indices`` (an
    ``index``/``index_put`` index list) indexes."""

    if not isinstance(x, DTensor):
        return False
    idx_dims = {i for i, t in enumerate(indices) if t is not None}
    return any(isinstance(p, Shard) and p.dim in idx_dims for p in x.placements)


def _sharded_on_dim(x, dim) -> bool:
    """Whether the DTensor ``x`` is sharded along its dim ``dim``."""

    if not isinstance(x, DTensor):
        return False
    dim %= x.ndim
    return any(isinstance(p, Shard) and p.dim == dim for p in x.placements)


def _local_as(t, mesh, placements):
    """The local block of ``t`` under ``placements`` (a plain tensor is
    a replicated constant: it is returned as it is where every placement
    replicates, else made a DTensor first)."""

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


_LOCAL_SHAPES: Dict[tuple, tuple] = {}


def _local_shape(x) -> tuple:
    """This rank's shard shape of the DTensor ``x`` under its placements,
    remembered by everything it depends on (global shape, placements,
    the mesh's shape and this rank's coordinate): every op's outputs are
    checked, and a step repeats its shapes."""
    mesh = x.device_mesh
    key = (tuple(x.shape), tuple(x.placements), tuple(mesh.shape),
           tuple(mesh.get_coordinate() or ()))
    out = _LOCAL_SHAPES.get(key)
    if out is None:
        from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

        out = tuple(compute_local_shape_and_global_offset(key[0], mesh, x.placements)[0])
        _LOCAL_SHAPES[key] = out
    return out


def _inconsistent(out):
    """The first output DTensor whose local shard is not the shape its
    layout gives (a sharding rule of the installed DTensor that got the
    layout wrong), else None."""

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


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for s in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(int(s), 1)
    return tuple(reversed(stride))


# ---------------------------------------------------------------------------
# the attention and the flash-decode kernel on each rank's shards
# ---------------------------------------------------------------------------


def attention_on_local_shards(q, k, v, cfg, scale, triangular):
    """``models.layers``' blockwise attention on DTensors (its caller
    routes them here): each rank runs the block loop under ``local_map``
    on its own shards of q, k and v, as the reference's attention runs
    inside its SPMD program, with the reference's placements.  A mesh dim
    that shards the batch of q, k and v alike, or their heads where it
    divides both the query and the kv heads (a rank's query heads then
    fall on its own kv heads), keeps its shards; any other is gathered
    first (the sequence always is).  Run op by op on DTensors the loop
    would take ~10 dispatches per block step (minutes a layer at 32k
    tokens), and its layout would follow the installed DTensor's
    choices."""
    from torch.distributed.tensor.experimental import local_map

    from ..models import layers

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
        return layers._blockwise_attention(q_l, k_l, v_l, local_cfg, scale, triangular)

    return local_map(block, out_placements=pq, in_placements=(pq, pkv, pkv),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def flash_decode_on_local_shards(q, k_cache, v_cache, lens):
    """``kernels.flash_decode.flash_decode_cache`` on DTensors: q (B, KV,
    G, d), the caches (B, S, KV, d) and lens (B,).  Each rank launches
    the kernel on its own batch, kv-head and sequence shards of the
    cache, q and lens laid out to match (a mesh dim that shards the
    sequence or replicates the cache replicates them).  Over the mesh
    dims that shard the sequence, each rank's launch reads its own block
    of positions with ``lens`` clipped to that block (0 where the block
    holds none of a row) and returns its log-sum-exp too; the ranks then
    combine their partial outputs with one all-reduce MAX of the
    log-sum-exps and one all-reduce SUM of ``exp(lse - max) * o`` beside
    ``exp(lse - max)``, and never gather the cache."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from ..kernels import flash_decode as fd

    mesh = k_cache.device_mesh
    if k_cache.placements != v_cache.placements:
        raise ValueError(f"k and v caches laid out apart: {k_cache.placements} "
                         f"and {v_cache.placements}")
    pq, plen, seq_dims = [], [], []
    for i, p in enumerate(k_cache.placements):
        if isinstance(p, Shard) and p.dim in (0, 2):
            pq.append(Shard(0 if p.dim == 0 else 1))
            plen.append(Shard(0) if p.dim == 0 else Replicate())
        elif p.is_replicate() or (isinstance(p, Shard) and p.dim == 1):
            pq.append(Replicate())
            plen.append(Replicate())
            if not p.is_replicate():
                seq_dims.append(i)
        else:
            raise ValueError(f"a cache laid out as {k_cache.placements}")
    if not is_dtensor(lens):
        lens = _replicated(lens, mesh)
    with running() as mode:
        q_l = q.redistribute(mesh, pq).to_local()
        lens_l = lens.redistribute(mesh, plen).to_local()
        k_l, v_l = k_cache.to_local(), v_cache.to_local()
        if not seq_dims:
            out = fd.flash_decode_cache(q_l, k_l, v_l, lens_l)
        else:
            local_shape, offset = compute_local_shape_and_global_offset(
                tuple(k_cache.shape), mesh, k_cache.placements)
            mine = torch.clamp(lens_l.long() - offset[1], 0, local_shape[1]).to(torch.int32)
            o, lse = fd.flash_decode_cache(q_l, k_l, v_l, mine, return_lse=True)
            top = mode._all_reduce(lse, mesh, seq_dims, "max")
            w = torch.exp(lse - torch.where(torch.isfinite(top), top, 0.0))
            parts = torch.cat([w[..., None] * o.float(), w[..., None]], dim=-1)
            parts = mode._all_reduce(parts, mesh, seq_dims, "sum")
            out = (parts[..., :-1] / torch.clamp(parts[..., -1:], min=1e-30)).to(q.dtype)
    return DTensor.from_local(out, mesh, pq, run_check=False, shape=q.shape,
                              stride=_contiguous_stride(q.shape))


def _replicated(t, mesh):
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


# ---------------------------------------------------------------------------
# trees of DTensors
# ---------------------------------------------------------------------------


def mesh_of(tree):
    """The ``DeviceMesh`` of the first DTensor leaf of ``tree``, or None
    (a tree of plain tensors)."""
    from .._tree import leaves

    for t in leaves(tree):
        if is_dtensor(t):
            return t.device_mesh
    return None


def active() -> Optional[SpmdMode]:
    """The innermost ``SpmdMode`` open on this thread, or None."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack

    for m in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(m, SpmdMode):
            return m
    return None


@contextlib.contextmanager
def running():
    """What a step on DTensors needs, opened once (a block inside an open
    one runs in that one): an ``SpmdMode``, yielded so the caller can read
    its collectives, and ``implicit_replication`` (a plain tensor the step
    makes itself, an arange or a mask, is a replicated constant, as in
    the reference's SPMD program)."""
    mode = active()
    if mode is not None:
        yield mode
        return
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication(), SpmdMode() as mode:
        yield mode


def distribute(tree, specs, mesh, spmd=None):
    """``tree``'s logical tensors as DTensors on ``spmd`` (default
    ``mesh``) laid out by the spec tree ``specs``: each rank's local
    shard is its ``shardings.shard_of`` slice, copied; a meta tensor's
    shard is a meta tensor of rank 0's shape (the dry run).  No
    collective runs."""

    spmd = mesh if spmd is None else spmd

    def one(spec, t):
        if t.device.type == "meta":
            local = torch.empty(SH.local_shape(t.shape, spec, mesh), dtype=t.dtype,
                                device="meta")
        else:
            local = SH.shard_of(t, spec, mesh).clone()
        return DTensor.from_local(local, spmd, SH.placements(spmd, spec), run_check=False,
                                  shape=t.shape, stride=_contiguous_stride(t.shape))

    return SH.map_specs(one, specs, tree)


def from_local(tree, specs, mesh):
    """This rank's slices (``shardings.place``) as the DTensors they are
    shards of, sharing their memory (no copy, no collective)."""

    def one(spec, t):
        if is_dtensor(t):
            return t
        shape = list(t.shape)
        for i, pl in enumerate(SH.placements(mesh, spec)):
            if pl.is_shard():
                shape[pl.dim] *= int(mesh.size(i))
        return DTensor.from_local(t, mesh, SH.placements(mesh, spec), run_check=False,
                                  shape=torch.Size(shape), stride=_contiguous_stride(shape))

    return SH.map_specs(one, specs, tree)


def to_local(tree):
    """Each DTensor leaf's local shard (plain leaves as they are)."""
    return SH.map_leaves(lambda t: t.to_local() if is_dtensor(t) else t, tree)


def redistribute(tree, specs, mesh):
    """Each DTensor leaf laid out anew by ``specs`` (plain leaves as they
    are)."""
    def one(spec, t):
        if is_dtensor(t):
            return t.redistribute(mesh, SH.placements(mesh, spec))
        return t

    return SH.map_specs(one, specs, tree)


def undistribute(tree):
    """The inverse of ``distribute``: each DTensor leaf's logical tensor
    on every rank (``full_tensor``, all-gathers and all-reduces as its
    layout needs; every rank calls it)."""
    with running():
        return SH.map_leaves(lambda t: t.full_tensor() if is_dtensor(t) else t, tree)
