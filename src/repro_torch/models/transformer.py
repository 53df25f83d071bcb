"""Decoder-only LM (llama / qwen / starcoder, and the MoE families).

Counterpart of ``repro/models/transformer.py``.  Layer
parameters are stacked with a leading ``n_layers`` axis, as the
reference's vmapped init leaves them, and the layers run as a Python
loop over that axis (the reference's ``lax.scan``).  Covers the training
forward and ``loss_fn``, prefill (``forward``) and single-token decode
with a KV cache of shape (n_layers, B, S_max, n_kv, d_head);
``decode_step`` writes the cache in place and returns the same tensors
(the reference returns new arrays).

``remat`` is the reference's activation-checkpoint policy, applied to
each layer of the loop: ``"full"`` keeps only the layer's input and
recomputes the rest in the backward pass
(``torch.utils.checkpoint.checkpoint``); ``"dots"``, the counterpart of
``checkpoint_dots_with_no_batch_dims``, keeps the outputs of the
matrix products with no batch dimension (the projections and MLP
matrices: ``aten.mm``, and the one-batch ``aten.bmm`` that ``einsum``
lays such a product out as) and recomputes everything else.  At one
sequence and one kv head the attention products are one-batch too and
are kept as well.  Gradients are the same under all three.

A config with ``moe`` set (``MoEFields``) replaces each layer's MLP by
``models/moe.py``'s block.  ``moe_impl="einsum"`` is that block;
``"shardmap"``, the reference's explicit collective schedule over a
(data, model) mesh, needs ranks and raises (ROADMAP item 16).

``init_params`` allocates each stacked leaf once, ``[n_layers, ...]`` in
its dtype, and fills it layer by layer: its peak is the stack plus one
layer (qwen3-moe-30b-a3b's 59.5 GB of bf16 weights fit one 80 GB card
only so).

Left out: ``unroll_layers`` only steered XLA's cost accounting of the
scan.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
from torch.utils import checkpoint as ckpt

from .._device import resolve
from . import layers as L
from . import moe as M
from .layers import params_from_numpy  # noqa: F401  (re-exported)


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0  # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    mlp_kind: str = "swiglu"  # swiglu (3-matrix) | gelu (2-matrix)
    attn_impl: str = "chunked"  # chunked | tri (triangular block schedule)
    moe_impl: str = "einsum"  # einsum; shardmap (explicit collectives) needs ranks
    norm: str = "rmsnorm"
    tie_embeddings: bool = True
    # MoE fields (None => dense)
    moe: Optional["MoEFields"] = None
    remat: str = "none"  # none | full | dots (activation checkpoint policy)

    def __post_init__(self):
        if self.moe_impl == "shardmap":
            raise NotImplementedError(
                "moe_impl='shardmap' is the reference's collective schedule over a "
                "(data, model) mesh: it needs ranks across GPUs, ROADMAP item 16; on one "
                "card use 'einsum'")

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def attn_config(self) -> L.AttnConfig:
        return L.AttnConfig(
            d_model=self.d_model,
            n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads,
            d_head=self.head_dim,
            rope_theta=self.rope_theta,
            qkv_bias=self.qkv_bias,
            attn_impl=self.attn_impl,
        )

    def param_count(self) -> int:
        """Exact parameter count."""
        return self._count(active=False)

    def active_param_count(self) -> int:
        """Parameters used per token (MoE: the top-k and shared experts only)."""
        return self._count(active=True)

    def _count(self, active: bool) -> int:
        d, h, kv, dh, ff = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim, self.d_ff
        attn = d * (h + 2 * kv) * dh + h * dh * d
        if self.moe is None:
            mlp = (3 if self.mlp_kind == "swiglu" else 2) * d * ff
        else:
            m = self.moe
            routed = m.top_k if active else m.n_experts
            mlp = routed * 3 * d * ff + m.n_shared * 3 * d * m.shared_d_ff + d * m.n_experts
        per_layer = attn + mlp + 2 * d
        return self.n_layers * per_layer + self.vocab * d + d


@dataclasses.dataclass(frozen=True)
class MoEFields:
    n_experts: int
    top_k: int
    n_shared: int = 0
    shared_d_ff: int = 0
    capacity_factor: float = 1.25
    # pins the reference's dispatch and combine shardings (GSPMD); one
    # card has nothing to pin, so it changes nothing here
    shard_dispatch: bool = False
    # hierarchical dispatch: each expert's capacity slots partitioned by
    # source data shard (slot = e*C + shard*C_local + local_rank)
    dispatch_shards: int = 0


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_init(gen: torch.Generator, cfg: LMConfig, dtype, dev) -> Dict[str, Any]:
    """One layer's tree, drawn from ``gen``: attention, then the MLP."""
    norm = L.rmsnorm_init if cfg.norm == "rmsnorm" else L.layernorm_init
    attn = L.attention_init(gen, cfg.attn_config, dtype, dev)
    if cfg.moe is not None:
        mlp = M.moe_init(gen, cfg, dtype, dev)
    else:
        mlp_init = L.gelu_mlp_init if cfg.mlp_kind == "gelu" else L.swiglu_init
        mlp = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype, dev)
    return {"attn": attn, "ln1": norm(cfg.d_model, device=dev),
            "ln2": norm(cfg.d_model, device=dev), "mlp": mlp}


def _stack_layer(stack, tree, i: int, n_layers: int):
    """Copy layer ``i``'s ``tree`` into ``stack``, whose leaves are
    allocated as ``[n_layers, ...]`` from layer 0's when ``stack`` is None;
    returns the stack."""
    if isinstance(tree, dict):
        return {k: _stack_layer(None if stack is None else stack[k], v, i, n_layers)
                for k, v in tree.items()}
    if stack is None:
        stack = tree.new_empty((n_layers,) + tuple(tree.shape))
    stack[i].copy_(tree)
    return stack


def init_params(gen: torch.Generator, cfg: LMConfig, dtype=torch.bfloat16,
                device=None) -> Dict[str, Any]:
    """Random parameters drawn from ``gen``, every layer leaf stacked with
    a leading ``n_layers`` axis (the reference vmaps its layer init); norms
    and the MoE router in float32, the rest in ``dtype``.  Each stacked
    leaf is allocated once and filled layer by layer, the draws in layer
    order."""
    dev = resolve(device)
    norm = L.rmsnorm_init if cfg.norm == "rmsnorm" else L.layernorm_init
    embed = L.embedding_init(gen, cfg.vocab, cfg.d_model, dtype, dev)
    layers = None
    for i in range(cfg.n_layers):
        layers = _stack_layer(layers, _layer_init(gen, cfg, dtype, dev), i, cfg.n_layers)
    return {"embed": embed, "layers": layers, "ln_f": norm(cfg.d_model, device=dev)}


def _layer(tree, i: int):
    """Layer ``i`` of a stacked parameter tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------


def _norm(cfg: LMConfig, p, x):
    return L.rmsnorm(p, x) if cfg.norm == "rmsnorm" else L.layernorm(p, x)


def _mlp(cfg: LMConfig, p, x):
    """The layer's MLP: the MoE block when the config has ``moe``."""
    if cfg.moe is not None:
        return M.moe_apply(p, cfg, x)
    return L.gelu_mlp(p, x) if cfg.mlp_kind == "gelu" else L.swiglu(p, x)


def _block(cfg: LMConfig, lp, x, positions):
    h = x + L.attention(lp["attn"], cfg.attn_config, _norm(cfg, lp["ln1"], x), positions)
    return h + _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], h))


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the products with no batch dimension, recompute the rest."""
    if op is torch.ops.aten.mm.default or (op is torch.ops.aten.bmm.default
                                           and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return ckpt.create_selective_checkpoint_contexts(_dots_policy)


def forward(params, cfg: LMConfig, tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) tokens -> (B, S, V) float32 logits."""
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens)
    positions = torch.arange(S, device=tokens.device)[None, :]
    body = functools.partial(_block, cfg)
    if cfg.remat == "full":
        body = functools.partial(ckpt.checkpoint, body, use_reentrant=False)
    elif cfg.remat == "dots":
        body = functools.partial(ckpt.checkpoint, body, use_reentrant=False,
                                 context_fn=_dots_context)
    for i in range(cfg.n_layers):
        x = body(_layer(params["layers"], i), x, positions)
    x = _norm(cfg, params["ln_f"], x)
    return L.unembed(params["embed"], x)


def loss_fn(params, cfg: LMConfig, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = forward(params, cfg, tokens)
    return L.cross_entropy(logits, labels)


def prefill(params, cfg: LMConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Prefill logits for a full prompt (the ``prefill_*`` shapes)."""
    return forward(params, cfg, tokens)


# ---------------------------------------------------------------------------
# decode with a KV cache
# ---------------------------------------------------------------------------


def init_kv_cache(cfg: LMConfig, batch: int, max_len: int, dtype=torch.bfloat16, device=None):
    dev = resolve(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "len": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def decode_step(params, cfg: LMConfig, cache, token: torch.Tensor,
                use_flash_kernel: bool = False):
    """One token for every sequence: (B,) token ids -> ((B, V) float32
    logits, cache).  Each layer's new key and value go into ``cache``'s
    tensors in place (a row at ``len >= S_max`` writes nothing); the
    returned cache holds the same tensors and ``len + 1``."""
    x = L.embed(params["embed"], token[:, None])
    cache_len = cache["len"]
    for i in range(cfg.n_layers):
        lp = _layer(params["layers"], i)
        a, _, _ = L.attention_decode(
            lp["attn"], cfg.attn_config, _norm(cfg, lp["ln1"], x), cache["k"][i], cache["v"][i],
            cache_len, use_flash_kernel=use_flash_kernel,
        )
        x = x + a
        x = x + _mlp(cfg, lp["mlp"], _norm(cfg, lp["ln2"], x))
    x = _norm(cfg, params["ln_f"], x)
    logits = L.unembed(params["embed"], x)[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "len": cache_len + 1}
