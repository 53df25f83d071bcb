"""Layer helpers the GNNs use: ``_normal`` and ``cross_entropy``.

Counterpart of ``repro/models/layers.py:19`` and ``:347``.  The rest of
that module (norms, RoPE, attention, MLPs) comes with the transformer
slice.  ``jax.random`` keys become explicit ``torch.Generator``s; the
two draw different numbers from one seed, so tests carry the
reference's parameters across (``models.gnn.common.params_from_numpy``).
"""
from __future__ import annotations

from typing import Optional

import torch


def _normal(gen: torch.Generator, shape, scale: float, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """Standard normal draws from ``gen`` (on the generator's device),
    times ``scale``, as ``dtype`` on ``device``."""
    x = torch.randn(tuple(shape), generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(dtype=dtype, device=device)


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
