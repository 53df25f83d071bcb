"""train_step builders: loss -> grads -> clip -> AdamW, with optional
microbatching (gradient accumulation) and remat from the model config.

Counterpart of ``repro/train/train_step.py:17-140``.  The step is eager:
the parameters are detached into leaves that require grad, the loss runs
forward, ``torch.autograd.grad`` gives the gradients, and the optimizer
builds the new state under ``no_grad`` (the reference's pure function,
jitted).  ``_accumulate`` splits axis 0 of every batch tensor into
``n_micro`` slices and sums loss and float32 gradients over them in
order, where the reference scans, then scales both by ``1 / n_micro``.
One loss adapter per architecture family.

Across data ranks (``make_train_step(..., mesh=, specs=)`` on a
``(k, 1)`` ("data", "model") ``DeviceMesh``): ZeRO-1, as the
reference's cells lay it out (``launch/cells.py:76-79``, ``:383``).
Each rank takes its 1/k of the global batch (its ``n_micro`` slices of
it); loss and float32 gradients are all-reduced, a sum then ``* 1/k``,
so every rank holds the full averaged gradient and the global-norm clip
sees the one-rank norm; AdamW updates this rank's slice of the
parameters and of ``m`` and ``v`` where the state's specs shard them
(``zero1_specs``), whole leaves elsewhere, and the parameters are then
all-gathered.  Two ranks at one slice each give the one-rank step at
``n_micro=2`` bit for bit (its ``(0 + g0) + g1`` is the all-reduce's
``g0 + g1``; AdamW is elementwise).

On a ``(d, m)`` mesh with m > 1 (``_model_parallel_step``) the step runs
on DTensors under ``dist.spmd``: the reference's cells as GSPMD lays
them out, the same program the dry run counts.  So does a step given
``batch_specs`` (the GNN cells' layouts, on any mesh): each batch tensor
is laid out by its spec, not as rows over the data axis.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from .._tree import leaves, tree_map, unflatten
from ..optim import adamw


class TrainState(NamedTuple):
    params: Any
    opt: adamw.AdamWState


def init_state(params) -> TrainState:
    return TrainState(params, adamw.init(params))


def _value_and_grad(loss_fn, params, batch):
    """(loss, grads): the gradient of ``loss_fn(params, batch)`` with
    respect to every parameter leaf, in the leaf's dtype (zeros for a
    leaf the loss does not read, as ``jax.grad`` gives)."""
    flat = [p.detach().requires_grad_(True) for p in leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(unflatten(params, flat), batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
    return loss.detach(), unflatten(params, grads)


def _accumulate(loss_fn, params, batch, n_micro: int, wrap=None):
    """Gradient accumulation: split the batch into n_micro slices along
    axis 0 and average loss and grads over them — activation memory drops
    n_micro-fold.  ``wrap`` (default none) maps each slice before the
    loss reads it (the model-parallel step lays it out over the ranks)."""
    wrap = wrap or (lambda b: b)
    if n_micro <= 1:
        return _value_and_grad(loss_fn, params, wrap(batch))

    def micro(i):
        def take(x):
            if not torch.is_tensor(x):
                return x
            if x.shape[0] % n_micro:
                raise ValueError(f"batch axis {x.shape[0]} does not split into {n_micro} slices")
            mb = x.shape[0] // n_micro
            return x[i * mb:(i + 1) * mb]

        return tree_map(take, batch)

    acc_loss = None
    acc_g = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
    for i in range(n_micro):
        loss, grads = _value_and_grad(loss_fn, params, wrap(micro(i)))
        acc_loss = loss.float() if acc_loss is None else acc_loss + loss
        acc_g = tree_map(torch.add, acc_g, grads)
    inv = 1.0 / n_micro
    return acc_loss * inv, tree_map(lambda g: g * inv, acc_g)


def make_train_step(
    loss_of_batch: Callable[[Any, Dict[str, torch.Tensor]], torch.Tensor],
    lr_schedule: Callable[[torch.Tensor], torch.Tensor],
    clip_norm: float = 1.0,
    weight_decay: float = 0.1,
    n_micro: int = 1,
    mesh=None,
    specs=None,
    batch_specs=None,
):
    """Generic: loss_of_batch(params, batch) -> scalar.  The step returns
    ``(new TrainState, {"loss", "grad_norm", "lr"})``, the metrics as
    float32 scalar tensors on the params' device.

    With ``mesh`` (a ("data", "model") ``DeviceMesh``) and ``specs`` (the
    ``TrainState``'s spec tree, ZeRO-1 moments) the state holds each
    rank's ``dist.shardings.place`` of it and every rank is given the
    global batch.  On a ``(k, 1)`` mesh: the data-parallel step of the
    module docstring; ``n_micro`` is then the slices of each rank's 1/k.
    On a mesh whose ``model`` axis has more than one rank, or with
    ``batch_specs`` (a spec tree of the batch's structure):
    ``_model_parallel_step``.  A batch laid out by ``batch_specs`` is
    taken whole (a full-graph batch is one graph), so ``n_micro`` must
    then be 1, as the reference's GNN cells never set it.  Without
    ``mesh`` (or at k = 1) the batch split, the all-reduce, the slicing
    and the gather are each the identity, and are skipped."""
    from ..dist import shardings as SH

    if batch_specs is not None and (mesh is None or n_micro > 1):
        raise ValueError("batch_specs lay a whole batch out on a mesh: they need a mesh "
                         f"and n_micro 1 (mesh {mesh}, n_micro {n_micro})")
    if mesh is not None and (SH.axis_sizes(mesh).get("model", 1) > 1
                             or batch_specs is not None):
        return _model_parallel_step(loss_of_batch, lr_schedule, clip_norm, weight_decay,
                                    n_micro, mesh, specs, batch_specs)
    k, idx, group = (1, 0, None) if mesh is None else data_ranks(mesh)
    m_specs = None if mesh is None else leaves(specs.opt.m)

    def local(tree):
        """This rank's ``zero1_specs`` slice of each leaf of ``tree``."""
        if mesh is None:
            return tree
        return unflatten(tree, [SH.shard_of(x, sp, mesh) for x, sp in zip(leaves(tree), m_specs)])

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, grads = _accumulate(loss_of_batch, state.params, rank_rows(batch, idx, k),
                                  n_micro)
        if k > 1:
            loss, grads = _mean_over_ranks(loss, grads, group, k)
        grads, gnorm = adamw.clip_by_global_norm(grads, clip_norm)
        lr = lr_schedule(state.opt.step)
        new_params, new_opt = adamw.update(
            state.opt, local(grads), local(state.params), lr, weight_decay=weight_decay
        )
        if mesh is not None:
            new_params = unflatten(state.params, [SH.gather_shard(p, sp, mesh)
                                                  for p, sp in zip(leaves(new_params), m_specs)])
        return TrainState(new_params, new_opt), {
            "loss": loss,
            "grad_norm": gnorm,
            "lr": lr,
        }

    return train_step


def _model_parallel_step(loss_of_batch, lr_schedule, clip_norm: float, weight_decay: float,
                         n_micro: int, mesh, specs, batch_specs=None):
    """The step on a ``(d, m)`` ("data", "model") mesh with m > 1: the
    reference's cells as GSPMD runs them.  Inside the step the state's
    slices are the DTensors they are shards of (``dist.spmd.from_local``:
    the parameters by ``lm_param_specs`` or ``dcn_param_specs``, the
    moments by their ``zero1_specs`` over both axes) and each rank's
    ``n_micro`` slices of its 1/d of the batch are laid out on the data
    axis (with ``batch_specs``, the whole batch by those specs instead:
    each rank is given the global batch and keeps its shards); the loss and its gradients run under ``dist.spmd.running``
    (Megatron tensor parallelism: heads, ``d_ff`` and vocab over
    ``model``).  Each gradient is then laid out as its parameter
    (an all-reduce over the data axis where it is a partial sum there),
    the global-norm clip reads the DTensors' norm (each model-sharded
    leaf's squares summed over its shards once, a replicated leaf once),
    AdamW updates each rank's ZeRO-1 slice, and the new state is laid out
    by ``specs`` again (the parameters all-gathered over the data axis)
    and handed back as this rank's slices.  Not bit-identical to one
    rank: the sharded products and reductions add in another order."""
    from ..dist import shardings as SH
    from ..dist import spmd

    k, idx, _ = data_ranks(mesh)
    entry = SH._batch_entry(mesh)

    def on_ranks(mb):
        """This rank's rows as the DTensors they are the data axis's
        shards of."""
        def one(x):
            if not torch.is_tensor(x):
                return x
            return spmd.from_local(x, SH.P(entry, *([None] * (x.ndim - 1))), mesh)

        return tree_map(one, mb)

    def value(t):
        return t.full_tensor() if spmd.is_dtensor(t) else t

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        with spmd.running():
            st = spmd.from_local(state, specs, mesh)
            if batch_specs is not None:
                loss, grads = _value_and_grad(loss_of_batch, st.params,
                                              spmd.distribute(batch, batch_specs, mesh))
            else:
                loss, grads = _accumulate(loss_of_batch, st.params, rank_rows(batch, idx, k),
                                          n_micro, wrap=on_ranks)
            grads = spmd.redistribute(grads, specs.params, mesh)
            grads, gnorm = adamw.clip_by_global_norm(grads, clip_norm)
            lr = lr_schedule(st.opt.step)
            new_params, new_opt = adamw.update(st.opt, grads, st.params, lr,
                                               weight_decay=weight_decay)
            new = spmd.redistribute(TrainState(new_params, new_opt), specs, mesh)
            metrics = {"loss": value(loss), "grad_norm": value(gnorm), "lr": value(lr)}
        return spmd.to_local(new), metrics

    return train_step


def data_ranks(mesh) -> Tuple[int, int, Any]:
    """(k, this rank's index, process group) of the batch axis of a
    ("data", "model") mesh."""
    from ..dist import shardings as SH

    sizes = SH.axis_sizes(mesh)
    bax = SH.batch_axes(mesh)
    if len(bax) != 1:
        raise NotImplementedError(f"one batch axis, not {bax}")
    names = list(mesh.mesh_dim_names)
    return sizes[bax[0]], int(mesh.get_coordinate()[names.index(bax[0])]), \
        mesh.get_group(bax[0])


def rank_rows(batch, i: int, k: int):
    """Rank ``i`` of ``k``'s rows (axis 0) of every batch tensor (the
    batch itself at k = 1)."""
    if k == 1:
        return batch

    def take(x):
        if not torch.is_tensor(x):
            return x
        if x.shape[0] % k:
            raise ValueError(f"batch axis {x.shape[0]} does not split over {k} ranks")
        b = x.shape[0] // k
        return x[i * b:(i + 1) * b]

    return tree_map(take, batch)


def _mean_over_ranks(loss, grads, group, k: int):
    """Loss and float32 gradients averaged over ``group``'s ``k`` ranks in
    one all-reduce: a sum, then ``* 1/k`` (through host memory where
    gloo holds a CUDA tensor)."""
    import torch.distributed as dist

    gl = leaves(grads)
    flat = torch.cat([loss.float().reshape(1)] + [g.float().reshape(-1) for g in gl])
    if flat.is_cuda and dist.get_backend(group) == "gloo":
        host = flat.cpu()
        dist.all_reduce(host, group=group)
        flat = host.to(flat.device)
    else:
        dist.all_reduce(flat, group=group)
    flat = flat * (1.0 / k)
    parts = flat[1:].split([g.numel() for g in gl])
    return flat[0].clone(), unflatten(grads, [c.view(g.shape) for c, g in zip(parts, gl)])


# -- per-family batch adapters ------------------------------------------------

def lm_loss(cfg):
    from ..models import transformer as T

    def f(params, batch):
        return T.loss_fn(params, cfg, batch["tokens"], batch["labels"])

    return f


def gcn_loss(batch_static):
    from ..models.gnn import gcn

    def f(params, batch):
        return gcn.loss_fn(params, batch["graph"], batch["labels"], batch["label_mask"])

    return f


def sage_full_loss():
    from ..models.gnn import graphsage

    def f(params, batch):
        return graphsage.loss_fn_full(
            params, batch["graph"], batch["labels"], batch["label_mask"]
        )

    return f


def sage_sampled_loss():
    from ..models.gnn import graphsage

    def f(params, batch):
        return graphsage.loss_fn_sampled(
            params, batch["x_self"], batch["neigh_feats"], batch["neigh_masks"], batch["labels"]
        )

    return f


def schnet_loss(n_graphs: int):
    from ..models.gnn import schnet

    def f(params, batch):
        return schnet.loss_fn(params, batch["graph"], batch["targets"], n_graphs)

    return f


def graphcast_loss():
    from ..models.gnn import graphcast

    def f(params, batch):
        return graphcast.loss_fn(params, batch["graph"], batch["targets"])

    return f


def dcn_loss():
    from ..models.recsys import dcn_v2

    def f(params, batch):
        return dcn_v2.loss_fn(params, batch["dense"], batch["sparse_ids"], batch["labels"])

    return f
