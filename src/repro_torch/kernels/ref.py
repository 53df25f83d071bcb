"""Oracles for the port's kernels (the correctness contracts).

Counterpart of ``repro/kernels/ref.py:38-41``.  Each oracle computes the
kernel's function the most direct way — a float64 scatter-add, no
sortedness assumed — so tests can hold both the kernel and its plain
version against it.
"""
from __future__ import annotations

import torch


def segment_sum_sorted_ref(dst: torch.Tensor, msg: torch.Tensor, n_out: int) -> torch.Tensor:
    """out[d] = sum_{dst[e] == d} msg[e] for 0 <= d < n_out (float64)."""
    return segment_sum_weighted_sorted_ref(dst, None, msg, n_out)


def segment_sum_weighted_sorted_ref(
    dst: torch.Tensor, w: torch.Tensor | None, msg: torch.Tensor, n_out: int
) -> torch.Tensor:
    """out[d] = sum_{dst[e] == d} w[e] * msg[e] (``w=None``: unit weights)."""
    dst = dst.long()
    keep = (dst >= 0) & (dst < n_out)
    rows = msg.double()[keep]
    if w is not None:
        rows = rows * w.double()[keep][:, None]
    out = torch.zeros((n_out, msg.shape[1]), dtype=torch.float64, device=msg.device)
    return out.index_add_(0, dst[keep], rows)
