"""Public wrappers the engine calls (never the kernel modules directly).

Counterpart of ``repro/kernels/ops.py:177-235`` and ``:299-378``.  The
reference pads the edge axis to whole edge blocks with an out-of-range
dst (chunked: whole chunk rows with an out-of-range anchor) and adds one
extra destination block to swallow the padding.  The Hopper kernels take
ragged shapes as they are and never visit a row at or past ``n_out``, so
the same contract — any ``dst >= n_out`` is dropped — holds with no
padding.  The reference also gathers an adaptive stream's compacted hi
plane into an aligned (R, CHUNK) transient (``_gather_hi``); the Hopper
kernels read the compacted plane through an O(R) row index instead.
Launch shapes are fixed (no autotuner consult yet).
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


def segment_sum_chunked(
    anchors: torch.Tensor,
    deltas: torch.Tensor,
    ovf_pos: torch.Tensor,
    ovf_add: torch.Tensor,
    msg: torch.Tensor,
    n_out: int,
    hi: torch.Tensor | None = None,
    wide: torch.Tensor | None = None,
) -> torch.Tensor:
    """``segment_sum`` with a chunk-compressed dst lane (a
    ``core/compressed.ChunkedStream``'s arrays), decoded inside the kernel.
    msg row ``r * CHUNK + c`` pairs with chunk ``r`` column ``c``.  Pass
    ``hi``/``wide`` for adaptive streams."""
    args = _chunk_args(anchors, deltas, ovf_pos, ovf_add)
    m = msg.to(torch.float32).contiguous()
    if hi is None:
        return segment_reduce.segment_sum_sorted_chunked(*args, m, int(n_out))
    a, d, p, v = args
    return segment_reduce.segment_sum_sorted_chunked_adaptive(
        a, d, hi.contiguous(), wide.contiguous(), p, v, m, int(n_out))


def segment_sum_weighted_chunked(
    anchors: torch.Tensor,
    deltas: torch.Tensor,
    ovf_pos: torch.Tensor,
    ovf_add: torch.Tensor,
    w: torch.Tensor,
    msg: torch.Tensor,
    n_out: int,
    hi: torch.Tensor | None = None,
    wide: torch.Tensor | None = None,
) -> torch.Tensor:
    """Weighted ``segment_sum_chunked`` (weight pads are 0)."""
    args = _chunk_args(anchors, deltas, ovf_pos, ovf_add)
    wf = w.to(torch.float32).contiguous()
    m = msg.to(torch.float32).contiguous()
    if hi is None:
        return segment_reduce.segment_sum_weighted_chunked(*args, wf, m, int(n_out))
    a, d, p, v = args
    return segment_reduce.segment_sum_weighted_chunked_adaptive(
        a, d, hi.contiguous(), wide.contiguous(), p, v, wf, m, int(n_out))


def _chunk_args(anchors, deltas, ovf_pos, ovf_add):
    return (anchors.to(torch.int32).contiguous(), deltas.contiguous(),
            ovf_pos.to(torch.int32).contiguous(), ovf_add.to(torch.int32).contiguous())
