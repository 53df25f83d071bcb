"""Serving loop: batched prefill + decode with a KV cache.

Counterpart of ``repro/serve/decode.py``, with its signatures.
``serve_step`` (one new token per sequence) is what the ``decode_*`` and
``long_*`` shapes run; ``generate`` drives it from the host with greedy
or temperature sampling.  Greedy decoding picks the first of equal
maxima, as ``jnp.argmax`` does.  Sampling draws from a
``torch.Generator`` passed as ``key``: the same distribution as the
reference's ``jax.random.categorical``, not the same draws.  The
reference jits its step; here it runs eagerly.
"""
from __future__ import annotations

from typing import List, Optional

import torch

from ..models import transformer as T


def make_serve_step(cfg, use_flash_kernel: bool = False):
    """Returns serve_step(params, cache, token) -> (logits, cache')."""

    def serve_step(params, cache, token):
        return T.decode_step(params, cfg, cache, token, use_flash_kernel=use_flash_kernel)

    return serve_step


def make_prefill(cfg):
    def prefill_fn(params, tokens):
        logits = T.prefill(params, cfg, tokens)
        return logits[:, -1]  # next-token logits

    return prefill_fn


def generate(
    params,
    cfg,
    prompt: torch.Tensor,  # (B, S0)
    max_new: int,
    max_len: Optional[int] = None,
    temperature: float = 0.0,
    key: Optional[torch.Generator] = None,
    use_flash_kernel: bool = False,
) -> torch.Tensor:
    """Greedy (or sampled) generation on the parameters' device; returns
    (B, S0 + max_new).  The cache is bf16, as the reference's is.

    Parameters laid out over ranks (DTensors, ``dist.spmd.distribute``)
    bring their mesh: every rank calls ``generate`` with the same prompt,
    the cache is laid out by ``lm_cache_specs`` (``T.init_kv_cache``),
    the steps run under ``dist.spmd.running``, and each step's
    vocab-sharded logits are gathered before the token is picked, so
    every rank returns the same tokens."""
    from ..dist import spmd

    mesh = spmd.mesh_of(params)
    if mesh is None:
        return _generate(params, cfg, prompt, max_new, max_len, temperature, key,
                         use_flash_kernel, None)
    with spmd.running():
        return _generate(params, cfg, prompt, max_new, max_len, temperature, key,
                         use_flash_kernel, mesh)


def _generate(params, cfg, prompt, max_new, max_len, temperature, key, use_flash_kernel,
              mesh):
    from ..dist import spmd

    B, S0 = prompt.shape
    max_len = max_len or (S0 + max_new)
    device = params["embed"]["table"].device
    cache = T.init_kv_cache(cfg, B, max_len, device=device, mesh=mesh)
    step = make_serve_step(cfg, use_flash_kernel)

    def serve_step(params, cache, token):
        logits, cache = step(params, cache, token)
        # logits laid out over ranks are gathered: each rank picks the same token
        return (logits.full_tensor() if spmd.is_dtensor(logits) else logits), cache

    # prefill token by token through the cache (simple, exact); batched
    # prefill through forward() is make_prefill
    tokens = prompt.to(device)
    logits = None
    for s in range(S0):
        logits, cache = serve_step(params, cache, tokens[:, s])
    out = [tokens]
    for i in range(max_new):
        if temperature > 0.0 and key is not None:
            probs = torch.softmax(logits / temperature, dim=-1)
            cur = torch.multinomial(probs.to(key.device), 1, generator=key)[:, 0].to(device)
        else:
            cur = torch.argmax(logits, dim=-1)
        out.append(cur[:, None].to(tokens.dtype))
        if i < max_new - 1:
            logits, cache = serve_step(params, cache, cur)
    return torch.cat(out, dim=1)


def pad_requests(requests: List[torch.Tensor]) -> torch.Tensor:
    """Requests (1-D token tensors) left-padded with 0 to one (B, S0) batch."""
    S0 = max(r.shape[0] for r in requests)
    return torch.stack([torch.nn.functional.pad(r, (S0 - r.shape[0], 0), value=0)
                        for r in requests])


def batched_request_server(params, cfg, requests, max_new: int = 16):
    """Toy batched server: pad requests to one batch, generate, split.

    requests: list of 1-D token tensors."""
    prompt = pad_requests(requests)
    S0 = prompt.shape[1]
    out = generate(params, cfg, prompt, max_new)
    return [out[i, S0:] for i in range(len(requests))]
