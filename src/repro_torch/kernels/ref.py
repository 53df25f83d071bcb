"""Oracles for the port's kernels (the correctness contracts).

Counterpart of ``repro/kernels/ref.py:13-41``.  Each oracle computes the
kernel's function the most direct way — a float64 scatter-add, no
sortedness assumed; a decode as anchor + cumsum plus one step per escape
— so tests can hold both the kernel and its plain version against it.
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


def delta_decode_ref(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Padded decode oracle: out[i, j] = anchors[i] + sum(deltas[i, :j+1])
    (column 0 of deltas is 0), int64 throughout, cut to int32 at the end."""
    return (anchors.long()[:, None] + torch.cumsum(deltas.long(), dim=1)).to(torch.int32)


def delta_decode_chunked_ref(
    anchors: torch.Tensor, deltas: torch.Tensor, ovf_pos: torch.Tensor, ovf_add: torch.Tensor
) -> torch.Tensor:
    """Escape-lane decode oracle (``core/compressed.ChunkedStream`` rows):
    anchor + lane cumsum, then each escape k adds ovf_add[i, k] to every
    column >= ovf_pos[i, k] (unused slots carry pos == chunk_len, which
    never triggers).  int64 throughout, cut to int32 at the end."""
    base = anchors.long()[:, None] + torch.cumsum(deltas.long(), dim=1)
    cols = torch.arange(deltas.shape[1], device=deltas.device)
    step = cols[None, :, None] >= ovf_pos.long()[:, None, :]
    corr = torch.where(step, ovf_add.long()[:, None, :], 0).sum(-1)
    return (base + corr).to(torch.int32)
