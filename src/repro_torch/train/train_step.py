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


def _accumulate(loss_fn, params, batch, n_micro: int):
    """Gradient accumulation: split the batch into n_micro slices along
    axis 0 and average loss and grads over them — activation memory drops
    n_micro-fold."""
    if n_micro <= 1:
        return _value_and_grad(loss_fn, params, batch)

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
    acc_g = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    for i in range(n_micro):
        loss, grads = _value_and_grad(loss_fn, params, micro(i))
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
):
    """Generic: loss_of_batch(params, batch) -> scalar.  The step returns
    ``(new TrainState, {"loss", "grad_norm", "lr"})``, the metrics as
    float32 scalar tensors on the params' device."""

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, grads = _accumulate(loss_of_batch, state.params, batch, n_micro)
        grads, gnorm = adamw.clip_by_global_norm(grads, clip_norm)
        lr = lr_schedule(state.opt.step)
        new_params, new_opt = adamw.update(
            state.opt, grads, state.params, lr, weight_decay=weight_decay
        )
        return TrainState(new_params, new_opt), {
            "loss": loss,
            "grad_norm": gnorm,
            "lr": lr,
        }

    return train_step


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
