"""AdamW + gradient clipping + WSD schedule, as functions over parameter trees.

Counterpart of ``repro/optim/adamw.py:17-85``.  The state is a tree of
the params' structure (``_tree``: nested dicts, lists and NamedTuples of
tensors); the moments are float32 whatever the parameter dtype, ``step``
an int32 scalar tensor on the params' device, and ``update`` casts each
new parameter back to its dtype.  The update is the reference's, term
for term: bias-corrected moments, eps added to ``sqrt(v_hat)``, and the
decay ``weight_decay * p`` added to the step before the learning rate
scales it (``torch.optim.AdamW`` decays the parameter first and places
eps differently, so it is not used).  Every function runs under
``torch.no_grad()``: the optimizer is never differentiated.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from .._tree import leaves, tree_map, unflatten


class AdamWState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    m: Any  # first moment (float32 tree)
    v: Any  # second moment (float32 tree)


def _device(tree) -> torch.device:
    flat = leaves(tree)
    return flat[0].device if flat else torch.device("cpu")


@torch.no_grad()
def init(params) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
    step = torch.zeros((), dtype=torch.int32, device=_device(params))
    return AdamWState(step, zeros, tree_map(torch.clone, zeros))


@torch.no_grad()
def global_norm(tree) -> torch.Tensor:
    """The 2-norm of all leaves together.  On DTensor leaves (the
    model-parallel step's) each leaf's sum of squares is a partial sum
    over the mesh dims that shard it, a replicated leaf's is replicated,
    and their sum is a partial sum that DTensor takes with the replicated
    terms on one rank only: each shard's squares count once and each
    replicated leaf once, reduced before the square root."""
    return torch.sqrt(sum(torch.sum(leaf.float() ** 2) for leaf in leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def update(
    state: AdamWState,
    grads,
    params,
    lr: torch.Tensor | float,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
) -> Tuple[Any, AdamWState]:
    step = state.step + 1
    t = step.float()
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)

    def upd(p, g, m, v):
        gf = g.float()
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf * gf
        mh = m2 / bc1
        vh = v2 / bc2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m2, v2

    out = [upd(p, g, m, v) for p, g, m, v in
           zip(leaves(params), leaves(grads), leaves(state.m), leaves(state.v))]
    new_p = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    return new_p, AdamWState(step, new_m, new_v)


def wsd_schedule(warmup: int, stable: int, decay: int, peak_lr: float, floor: float = 0.1):
    """Warmup-Stable-Decay: the production LR schedule.  ``lr(step)``
    takes an int or a scalar tensor and returns a float32 scalar tensor
    (on the step's device)."""

    def lr(step):
        s = step.to(torch.float32) if torch.is_tensor(step) else torch.tensor(
            step, dtype=torch.float32)
        warm = peak_lr * torch.clamp(s / max(warmup, 1), max=1.0)
        total = warmup + stable
        frac = torch.clamp((s - total) / max(decay, 1), 0.0, 1.0)
        dec = peak_lr * (1.0 - (1.0 - floor) * frac)
        return torch.where(s < total, warm, dec)

    return lr
