"""Public wrappers the engine calls (never the kernel modules directly).

Counterpart of ``repro/kernels/ops.py:177-235``.  The reference pads the
edge axis to whole edge blocks with an out-of-range dst and adds one
extra destination block to swallow the padding.  The Hopper kernel takes
ragged shapes as they are and never visits a row at or past ``n_out``,
so the same contract — any ``dst >= n_out`` is dropped — holds with no
padding.  Launch shapes are fixed (no autotuner consult yet).
"""
from __future__ import annotations

import torch

from . import segment_reduce


def segment_sum(dst: torch.Tensor, msg: torch.Tensor, n_out: int) -> torch.Tensor:
    """Sorted segment sum: float32 (n_out, D) from dst (E,) and msg (E, D)."""
    return segment_reduce.segment_sum_sorted(
        dst.to(torch.int32).contiguous(), msg.to(torch.float32).contiguous(), int(n_out)
    )


def segment_sum_weighted(
    dst: torch.Tensor, w: torch.Tensor, msg: torch.Tensor, n_out: int
) -> torch.Tensor:
    """Weighted sorted segment sum (out[d] = sum w[e] * msg[e]); same
    dropping contract as ``segment_sum``."""
    return segment_reduce.segment_sum_weighted_sorted(
        dst.to(torch.int32).contiguous(),
        w.to(torch.float32).contiguous(),
        msg.to(torch.float32).contiguous(),
        int(n_out),
    )
