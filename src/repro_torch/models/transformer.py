"""Dense decoder-only LM (llama / qwen / starcoder families).

Counterpart of the dense part of ``repro/models/transformer.py``.  Layer
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

Left out: ``unroll_layers`` only steered XLA's cost accounting of the
scan; ``moe_impl`` and the MoE layers (``MoEFields``, a config with
``moe`` set) come with ROADMAP item 14 and raise until then.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch
from torch.utils import checkpoint as ckpt

from .._device import resolve
from . import layers as L
from .layers import params_from_numpy  # noqa: F401  (re-exported)

_MOE_TODO = "MoE layers are ROADMAP item 14; the port has the dense LMs only"


class MoEFields:
    """Placeholder for the reference's MoE config: MoE is ROADMAP item 14."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(_MOE_TODO)


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
    norm: str = "rmsnorm"
    tie_embeddings: bool = True
    moe: Optional[Any] = None  # must stay None: MoE is ROADMAP item 14
    remat: str = "none"  # none | full | dots (activation checkpoint policy)

    def __post_init__(self):
        if self.moe is not None:
            raise NotImplementedError(_MOE_TODO)

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
        d, h, kv, dh, ff = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim, self.d_ff
        attn = d * (h + 2 * kv) * dh + h * dh * d
        mlp = (3 if self.mlp_kind == "swiglu" else 2) * d * ff
        per_layer = attn + mlp + 2 * d
        return self.n_layers * per_layer + self.vocab * d + d

    def active_param_count(self) -> int:
        """Parameters used per token: all of them in a dense model."""
        return self.param_count()


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_init(gen: torch.Generator, cfg: LMConfig, dtype, dev) -> Dict[str, Any]:
    norm = L.rmsnorm_init if cfg.norm == "rmsnorm" else L.layernorm_init
    mlp = L.gelu_mlp_init if cfg.mlp_kind == "gelu" else L.swiglu_init
    return {
        "attn": L.attention_init(gen, cfg.attn_config, dtype, dev),
        "ln1": norm(cfg.d_model, device=dev),
        "ln2": norm(cfg.d_model, device=dev),
        "mlp": mlp(gen, cfg.d_model, cfg.d_ff, dtype, dev),
    }


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(gen: torch.Generator, cfg: LMConfig, dtype=torch.bfloat16,
                device=None) -> Dict[str, Any]:
    """Random parameters drawn from ``gen``, every layer leaf stacked with
    a leading ``n_layers`` axis (the reference vmaps its layer init); norms
    in float32, the rest in ``dtype``."""
    dev = resolve(device)
    norm = L.rmsnorm_init if cfg.norm == "rmsnorm" else L.layernorm_init
    return {
        "embed": L.embedding_init(gen, cfg.vocab, cfg.d_model, dtype, dev),
        "layers": _stack([_layer_init(gen, cfg, dtype, dev) for _ in range(cfg.n_layers)]),
        "ln_f": norm(cfg.d_model, device=dev),
    }


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
