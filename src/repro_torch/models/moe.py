"""Mixture-of-Experts MLP block (qwen3-moe, deepseek-moe configs).

Counterpart of ``repro/models/moe.py``.  Sort-based capacity dispatch:
  1. router logits (float32) -> top-k experts per token, probabilities
     renormalised over the k;
  2. flatten the (token, slot) pairs and sort them by expert, stably;
  3. the rank within its expert gives each pair a capacity slot; a pair
     past the capacity C is dropped;
  4. gather the tokens into (E, C, D), run every expert's SwiGLU as one
     batched product over the expert axis, and add each pair's output
     back to its token weighted by its router probability.

DeepSeek-style shared experts run densely beside the routed ones.

``route`` is steps 1-3 (the reference inlines them in ``moe_apply``);
its ``keep`` says which pairs found a slot.  The hierarchical branch
(``dispatch_shards > 1``) partitions each expert's C slots by the
source data shard; on one card it is a different slot layout of the
same computation.  ``shard_dispatch`` pins GSPMD shardings in the
reference (``with_sharding_constraint``); one card has nothing to pin,
so it is accepted and changes nothing.

Three details keep the port's routing equal to the reference's: the
sorts are stable (``jnp.argsort(stable=True)``), ``searchsorted`` takes
the left side, and the reference's out-of-range gather clamps (a
hierarchical group past the last one, when T is not a multiple of the
shard count, reads the last group's start).  A dropped pair is written
to a spare row past the E * C slots, which is then sliced off, as the
reference's ``mode="drop"`` scatter drops it.  The combine is
``index_add_``: on CUDA its adds land in no fixed order, so bf16 outputs
are not bit-stable from run to run (float32 ones differ by rounding).
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple

import torch
import torch.nn.functional as F

from .._device import resolve
from . import layers as L


def moe_init(gen: torch.Generator, cfg, dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Router (float32) and the experts' stacked SwiGLU weights drawn from
    ``gen`` in this order: router, w_gate, w_up, w_down, then the shared
    experts' SwiGLU (one of width ``shared_d_ff * n_shared``)."""
    dev = resolve(device)
    m = cfg.moe
    d, ff = cfg.d_model, cfg.d_ff
    s_in, s_out = d ** -0.5, ff ** -0.5
    p = {
        "router": L._normal(gen, (d, m.n_experts), s_in, torch.float32, dev),
        "w_gate": L._normal(gen, (m.n_experts, d, ff), s_in, dtype, dev),
        "w_up": L._normal(gen, (m.n_experts, d, ff), s_in, dtype, dev),
        "w_down": L._normal(gen, (m.n_experts, ff, d), s_out, dtype, dev),
    }
    if m.n_shared > 0:
        p["shared"] = L.swiglu_init(gen, d, m.shared_d_ff * m.n_shared, dtype, dev)
    return p


def _capacity(n_tokens: int, m) -> int:
    c = int(m.capacity_factor * n_tokens * m.top_k / m.n_experts)
    return max(8, -(-c // 8) * 8)  # round up to 8 (the reference's sublane alignment)


class Routing(NamedTuple):
    """Where each (token, slot) pair goes, in expert-sorted order."""

    top_p: torch.Tensor  # (T, k) float32 renormalised router probabilities
    top_e: torch.Tensor  # (T, k) int64 experts, best first
    order: torch.Tensor  # (T*k,) the stable sort of the flat pairs by group
    keep: torch.Tensor  # (T*k,) bool: the sorted pair found a slot
    slot: torch.Tensor  # (T*k,) int64 destination row in (E * C) for a kept pair
    src_tok: torch.Tensor  # (T*k,) int64 token of each sorted pair
    capacity: int  # C, slots per expert


def route(params: Dict[str, Any], cfg, xt: torch.Tensor) -> Routing:
    """Steps 1-3 for the tokens ``xt`` (T, D)."""
    m = cfg.moe
    T = xt.shape[0]
    C = _capacity(T, m)
    dev = xt.device
    logits = L._einsum("td,de->te", xt.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.topk(probs, m.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    flat_e = top_e.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(m.top_k)
    pos = torch.arange(T * m.top_k, device=dev)
    if m.dispatch_shards > 1:
        ns = m.dispatch_shards
        C_local = max(8, -(-C // ns))
        C = C_local * ns
        shard_of = flat_t // max(T // ns, 1)
        group = flat_e * ns + shard_of
        order = torch.argsort(group, stable=True)
        g_sorted = group[order]
        e_sorted = flat_e[order]
        first_of_g = torch.searchsorted(g_sorted, torch.arange(m.n_experts * ns, device=dev))
        # the reference's gather clamps an index past the last group
        rank = pos - first_of_g[torch.clamp(g_sorted, max=m.n_experts * ns - 1)]
        keep = rank < C_local
        slot = e_sorted * C + (g_sorted % ns) * C_local + rank
    else:
        order = torch.argsort(flat_e, stable=True)
        e_sorted = flat_e[order]
        first_of_e = torch.searchsorted(e_sorted, torch.arange(m.n_experts, device=dev))
        rank = pos - first_of_e[e_sorted]
        keep = rank < C
        slot = e_sorted * C + rank
    return Routing(top_p, top_e, order, keep, slot, flat_t[order], C)


def moe_apply(params: Dict[str, Any], cfg, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    r = route(params, cfg, xt)
    n_slots = m.n_experts * r.capacity

    # dispatch: a dropped pair goes to the spare row n_slots, sliced off
    dest = torch.where(r.keep, r.slot, n_slots)
    buf = x.new_zeros((n_slots + 1, D)).index_copy(0, dest, xt[r.src_tok])
    h = buf[:n_slots].reshape(m.n_experts, r.capacity, D)

    # grouped expert products
    g = L._einsum("ecd,edf->ecf", h, params["w_gate"])
    u = L._einsum("ecd,edf->ecf", h, params["w_up"])
    o = L._einsum("ecf,efd->ecd", F.silu(g) * u, params["w_down"]).reshape(n_slots, D)

    # combine: each kept pair's output, weighted by its router probability
    w = torch.where(r.keep, r.top_p.reshape(-1)[r.order], 0.0)[:, None].to(x.dtype)
    gathered = o[torch.where(r.keep, r.slot, 0)] * w
    out = torch.zeros((T, D), dtype=x.dtype, device=x.device).index_add(0, r.src_tok, gathered)

    if "shared" in params:
        out = out + L.swiglu(params["shared"], xt)
    return out.reshape(B, S, D)


def load_balance_loss(router_logits: torch.Tensor, top_e: torch.Tensor,
                      n_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * p_e."""
    probs = torch.softmax(router_logits, dim=-1)
    p_mean = probs.mean(dim=0)
    counts = torch.zeros(n_experts, dtype=probs.dtype, device=probs.device).index_add_(
        0, top_e.reshape(-1).long(),
        torch.ones(top_e.numel(), dtype=probs.dtype, device=probs.device))
    f = counts / torch.clamp(counts.sum(), min=1.0)
    return n_experts * torch.sum(f * p_mean)
