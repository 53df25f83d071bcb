"""Transformer building blocks: norms, RoPE, GQA attention, gated MLPs,
embeddings; and ``params_from_numpy``, which carries a reference
parameter tree across.

Counterpart of ``repro/models/layers.py``.  Parameters are nested dicts
of tensors, every layer ``init(gen, ...) -> params`` plus
``apply(params, x, ...) -> y``, with the reference's layouts:
activations (B, S, H, d), caches (B, S_max, n_kv, d), query head
``h = kv * g + j`` for GQA.  Dtypes are explicit: bf16 compute where the
weights are bf16, float32 norms, softmax and logits.  An einsum whose
operands differ in dtype promotes them as JAX does (bf16 with float32
gives float32), since torch's einsum refuses mixed operands.

``jax.random`` keys become explicit ``torch.Generator``s; the two draw
different numbers from one seed, so tests carry the reference's
parameters across with ``params_from_numpy``.

Two departures from the reference, both in ``attention_decode``: it
writes the new key and value into the cache in place (the reference's
``.at[].set`` copies), and at ``cache_len >= S_max`` it writes nothing,
as the reference's out-of-range ``.at[].set`` drops the write (here a
``where`` at the clamped slot, with no host sync).  ``_blockwise_attention``
has no ``unroll``: it only changed how XLA counted a scan's cost, and
eager torch has no scan.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from .._device import resolve
from ..kernels import flash_decode as fd

Params = Dict[str, Any]


def _normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """Standard normal draws from ``gen`` (on the generator's device),
    times ``scale``, as ``dtype`` on ``device``.  On the meta device it
    draws nothing and ``gen`` may be None: the dry run's cells take their
    parameters' shapes from the inits without allocating."""
    if torch.device(device).type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=device)
    x = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(dtype=dtype, device=device)


def _einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with the operands promoted to one dtype first."""
    dt = ops[0].dtype
    if any(o.dtype != dt for o in ops):
        for o in ops[1:]:
            dt = torch.promote_types(dt, o.dtype)
        ops = tuple(o.to(dt) for o in ops)
    return torch.einsum(eq, *ops)


def params_from_numpy(tree: Any, device=None) -> Any:
    """A parameter tree of numpy arrays (the reference's
    ``jax.tree.map(np.asarray, params)``) as the same tree of tensors on
    ``device``; dicts, lists and tuples keep their structure.  bf16
    leaves (numpy's ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
    refuses) travel as their uint16 bit pattern, so they arrive bit for
    bit."""
    dev = resolve(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, dev) for v in tree)
    if tree is None:
        return None
    a = np.array(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d: int, dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=resolve(device))}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return ((xf * rms) * params["scale"].float()).to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, device=None) -> Params:
    dev = resolve(device)
    return {"scale": torch.ones((d,), dtype=dtype, device=dev),
            "bias": torch.zeros((d,), dtype=dtype, device=dev)}


def layernorm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(d_head: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, H, d_head); positions: broadcastable to (..., S).  Each
    head splits into halves (not interleaved pairs); angles in float32."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)  # (d/2,)
    angles = positions[..., None].float() * freqs  # (..., S, d/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, d/2)
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., : d // 2].float(), x[..., d // 2:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    causal: bool = True
    # "chunked": visit all (q, kv) block pairs, mask above the diagonal.
    # "tri": per q-block only kv-blocks j <= i, and only the diagonal
    #        block pays the mask.
    attn_impl: str = "chunked"


def attention_init(gen: torch.Generator, cfg: AttnConfig, dtype=torch.bfloat16,
                   device=None) -> Params:
    dev = resolve(device)
    s = cfg.d_model ** -0.5
    p = {
        "wq": _normal(gen, (cfg.d_model, cfg.n_heads, cfg.d_head), s, dtype, dev),
        "wk": _normal(gen, (cfg.d_model, cfg.n_kv_heads, cfg.d_head), s, dtype, dev),
        "wv": _normal(gen, (cfg.d_model, cfg.n_kv_heads, cfg.d_head), s, dtype, dev),
        "wo": _normal(gen, (cfg.n_heads, cfg.d_head, cfg.d_model), s, dtype, dev),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((cfg.n_heads, cfg.d_head), dtype=dtype, device=dev)
        p["bk"] = torch.zeros((cfg.n_kv_heads, cfg.d_head), dtype=dtype, device=dev)
        p["bv"] = torch.zeros((cfg.n_kv_heads, cfg.d_head), dtype=dtype, device=dev)
    return p


def _qkv(params: Params, cfg: AttnConfig, x: torch.Tensor, positions: torch.Tensor):
    q = _einsum("bsd,dhk->bshk", x, params["wq"])
    k = _einsum("bsd,dhk->bshk", x, params["wk"])
    v = _einsum("bsd,dhk->bshk", x, params["wv"])
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


CHUNKED_ATTN_THRESHOLD = 2048  # the direct S^2 softmax above this is untenable
Q_BLOCK = 512
KV_BLOCK = 1024


def attention(params: Params, cfg: AttnConfig, x: torch.Tensor,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Training / prefill attention, x (B, S, D).  Up to
    ``CHUNKED_ATTN_THRESHOLD`` the direct softmax; above it the blockwise
    online softmax, so memory is O(S * block) rather than O(S^2)."""
    B, S, D = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q, k, v = _qkv(params, cfg, x, positions)
    g = cfg.n_heads // cfg.n_kv_heads
    scale = cfg.d_head ** -0.5
    if S <= CHUNKED_ATTN_THRESHOLD:
        qh = q.reshape(B, S, cfg.n_kv_heads, g, cfg.d_head)
        logits = _einsum("bshgk,bthk->bhgst", qh, k).float() * scale
        if cfg.causal:
            mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=x.device))
            logits = torch.where(mask[None, None, None], logits, -torch.inf)
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        o = _einsum("bhgst,bthk->bshgk", w, v).reshape(B, S, cfg.n_heads, cfg.d_head)
    else:
        triangular = cfg.attn_impl.startswith("tri") and cfg.causal
        from ..dist import spmd

        if spmd.is_dtensor(q):  # laid out over ranks: the loop on each rank's shards
            o = spmd.attention_on_local_shards(q, k, v, cfg, scale, triangular)
        else:
            o = _blockwise_attention(q, k, v, cfg, scale, triangular)
    return _einsum("bshk,hkd->bsd", o, params["wo"])


def _kv_step(q_i, k_j, v_j, m, l, acc, *, scale: float, causal: bool, qpos, kpos):
    """One (q block, kv block) step of the online softmax: the carries
    ``(m, l, acc)`` after attending ``q_i`` to ``k_j``/``v_j``.  ``qpos``
    and ``kpos`` are the blocks' positions where the step needs the
    causal mask, else None."""
    s = _einsum("bqhgk,bthk->bhgqt", q_i, k_j).float() * scale
    if causal:
        s = torch.where((qpos[:, None] >= kpos[None, :])[None, None, None], s, -torch.inf)
    m_c = s.amax(dim=-1, keepdim=True)
    m_n = torch.maximum(m, m_c)
    m_safe = torch.where(torch.isfinite(m_n), m_n, 0.0)
    p = torch.where(torch.isfinite(s), torch.exp(s - m_safe), 0.0)
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
    l = l * alpha[..., 0] + p.sum(-1)
    acc = acc * alpha.to(acc.dtype) + _einsum("bhgqt,bthk->bhgqk", p.to(v_j.dtype), v_j)
    return m_n, l, acc


def _blockwise_attention(q, k, v, cfg: AttnConfig, scale: float, triangular: bool):
    """Blockwise online-softmax attention over Q_BLOCK query rows and
    KV_BLOCK key rows at a time.  ``triangular`` skips kv-blocks wholly
    above the causal diagonal and masks only the diagonal block.  The
    accumulator is in q's dtype, the running max and sum in float32, as
    in the reference.  Each step runs under
    ``torch.utils.checkpoint`` whatever ``remat`` is, as the reference's
    ``kv_step`` runs under ``jax.checkpoint``: autograd keeps only the
    carries and the step's inputs, and the backward recomputes the
    step's score and probability blocks."""
    B, S, H, dh = q.shape
    Kv = cfg.n_kv_heads
    g = H // Kv
    nq, nk = S // Q_BLOCK, S // KV_BLOCK
    r = KV_BLOCK // Q_BLOCK
    if S % Q_BLOCK or S % KV_BLOCK:
        raise ValueError(f"blockwise attention needs S a multiple of {KV_BLOCK}, got {S}")
    qb = q.reshape(B, nq, Q_BLOCK, Kv, g, dh)
    kb = k.reshape(B, nk, KV_BLOCK, Kv, dh)
    vb = v.reshape(B, nk, KV_BLOCK, Kv, dh)
    dev = q.device
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    out_blocks = []
    for i in range(nq):
        q_i = qb[:, i]
        j_hi = (i // r) if triangular else nk - 1
        n_steps = j_hi + 1 if triangular else nk
        qpos = i * Q_BLOCK + torch.arange(Q_BLOCK, device=dev)
        m = torch.full((B, Kv, g, Q_BLOCK, 1), -torch.inf, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Kv, g, Q_BLOCK), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Kv, g, Q_BLOCK, dh), dtype=q.dtype, device=dev)
        for j in range(n_steps):
            causal = cfg.causal and (j == j_hi or not triangular)
            kpos = j * KV_BLOCK + torch.arange(KV_BLOCK, device=dev) if causal else None
            step = functools.partial(_kv_step, scale=scale, causal=causal, qpos=qpos, kpos=kpos)
            args = (q_i, kb[:, j], vb[:, j], m, l, acc)
            m, l, acc = (ckpt.checkpoint(step, *args, use_reentrant=False) if grad
                         else step(*args))
        o_i = acc / torch.clamp(l, min=1e-30)[..., None].to(acc.dtype)
        out_blocks.append(o_i.permute(0, 3, 1, 2, 4))
    return torch.stack(out_blocks, dim=1).reshape(B, S, H, dh)


def attention_decode(
    params: Params,
    cfg: AttnConfig,
    x: torch.Tensor,  # (B, 1, D) current token
    k_cache: torch.Tensor,  # (B, S_max, n_kv, d_head)
    v_cache: torch.Tensor,
    cache_len: torch.Tensor,  # (B,) int32
    use_flash_kernel: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step against a KV cache; returns (out, k_cache, v_cache).
    The new key and value go into the cache in place, at ``cache_len``;
    a row whose ``cache_len`` is at or past S_max writes nothing.  With
    ``use_flash_kernel`` the attention is ``flash_decode_cache``, which
    reads the cache where it lies; on a cache of DTensors each rank
    launches it on its own shards (``dist.spmd.flash_decode_on_local_shards``):
    its kv heads, or its block of positions, whose partial outputs the
    ranks combine by their log-sum-exps."""
    B = x.shape[0]
    S_max = k_cache.shape[1]
    q, k_new, v_new = _qkv(params, cfg, x, cache_len[:, None])
    rows = torch.arange(B, device=x.device)
    slot = torch.clamp(cache_len.long(), max=S_max - 1)
    keep = (cache_len < S_max)[:, None, None]
    k_cache[rows, slot] = torch.where(keep, k_new[:, 0].to(k_cache.dtype), k_cache[rows, slot])
    v_cache[rows, slot] = torch.where(keep, v_new[:, 0].to(v_cache.dtype), v_cache[rows, slot])
    g = cfg.n_heads // cfg.n_kv_heads
    if use_flash_kernel:
        qf = q.reshape(B, cfg.n_kv_heads, g, cfg.d_head)
        from ..dist import spmd

        if spmd.is_dtensor(k_cache):  # a cache laid out over ranks: each rank's shards
            o = spmd.flash_decode_on_local_shards(qf, k_cache, v_cache, cache_len + 1)
        else:
            o = fd.flash_decode_cache(qf, k_cache, v_cache, cache_len + 1)
        o = o.reshape(B, 1, cfg.n_heads, cfg.d_head)
    else:
        qh = q.reshape(B, 1, cfg.n_kv_heads, g, cfg.d_head)
        scale = cfg.d_head ** -0.5
        logits = _einsum("bqhgk,bthk->bhgqt", qh, k_cache).float() * scale
        pos = torch.arange(S_max, device=x.device)
        valid = pos[None, None, None, None, :] <= cache_len[:, None, None, None, None]
        logits = torch.where(valid, logits, -torch.inf)
        w = torch.softmax(logits, dim=-1).to(x.dtype)
        o = _einsum("bhgqt,bthk->bqhgk", w, v_cache).reshape(B, 1, cfg.n_heads, cfg.d_head)
    out = _einsum("bshk,hkd->bsd", o, params["wo"])
    return out, k_cache, v_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def swiglu_init(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.bfloat16,
                device=None) -> Params:
    dev = resolve(device)
    s_in, s_out = d_model ** -0.5, d_ff ** -0.5
    return {
        "w_gate": _normal(gen, (d_model, d_ff), s_in, dtype, dev),
        "w_up": _normal(gen, (d_model, d_ff), s_in, dtype, dev),
        "w_down": _normal(gen, (d_ff, d_model), s_out, dtype, dev),
    }


def swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    g = _einsum("...d,df->...f", x, params["w_gate"])
    u = _einsum("...d,df->...f", x, params["w_up"])
    return _einsum("...f,fd->...d", F.silu(g) * u, params["w_down"])


def gelu_mlp_init(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.bfloat16,
                  device=None) -> Params:
    """Plain 2-matrix GELU MLP (GPT / starcoder2 style)."""
    dev = resolve(device)
    return {
        "w_up": _normal(gen, (d_model, d_ff), d_model ** -0.5, dtype, dev),
        "w_down": _normal(gen, (d_ff, d_model), d_ff ** -0.5, dtype, dev),
    }


def gelu_mlp(params: Params, x: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh form, which ``jax.nn.gelu`` uses by default
    (torch's default is the exact erf)."""
    h = F.gelu(_einsum("...d,df->...f", x, params["w_up"]), approximate="tanh")
    return _einsum("...f,fd->...d", h, params["w_down"])


def mlp_init(gen: torch.Generator, d_in: int, dims, dtype=torch.float32, bias: bool = True,
             device=None) -> Params:
    dev = resolve(device)
    ws, bs = [], []
    d_prev = d_in
    for d in dims:
        ws.append(_normal(gen, (d_prev, d), d_prev ** -0.5, dtype, dev))
        bs.append(torch.zeros((d,), dtype=dtype, device=dev))
        d_prev = d
    return {"ws": ws, "bs": bs if bias else None}


def mlp(params: Params, x: torch.Tensor, act=torch.relu, final_act: bool = False) -> torch.Tensor:
    n = len(params["ws"])
    for i, w in enumerate(params["ws"]):
        x = _einsum("...d,df->...f", x, w)
        if params["bs"] is not None:
            x = x + params["bs"][i]
        if i < n - 1 or final_act:
            x = act(x)
    return x


# ---------------------------------------------------------------------------
# embeddings & logits
# ---------------------------------------------------------------------------


def embedding_init(gen: torch.Generator, vocab: int, d_model: int, dtype=torch.bfloat16,
                   device=None) -> Params:
    return {"table": _normal(gen, (vocab, d_model), 0.02, dtype, resolve(device))}  # GPT-2 init


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    """Tied logits: (B, S, D) @ (V, D)^T in float32."""
    return torch.einsum("bsd,vd->bsv", x.float(), params["table"].float())


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under ``logits``; with
    ``mask``, the mask-weighted mean (denominator at least 1)."""
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()
