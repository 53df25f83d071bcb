"""Decode of the compressed pool's dst lane, written from its layout.

The layout (``ChunkedStream``): rows of L slots; row i holds an int32
anchor, a lane of L deltas (int8 or int16; adaptive streams: int8, and
for a row tagged ``wide`` the delta is ``hi * 256 + (lane & 0xFF)`` with
``hi`` the row's entry in a plane that holds only the wide rows, in row
order), and K escapes, each a column and a full int32 delta added from
that column on (column L marks an unused escape).  Slot j of row i is
the anchor plus the deltas of columns 0..j plus the escapes at columns
<= j, wrapping in 32 bits.
"""
from __future__ import annotations

import torch


def decode(anchors, deltas, ovf_pos, ovf_add, hi=None, wide=None, block: int = 1 << 16):
    """int32 values of every slot, rows decoded ``block`` at a time."""
    R, L = deltas.shape
    out = torch.empty((R, L), dtype=torch.int32, device=deltas.device)
    hi_row = None
    if hi is not None:
        hi_row = torch.cumsum(wide.to(torch.int64), 0) - 1
    for lo in range(0, R, block):
        hi_ = min(R, lo + block)
        d = deltas[lo:hi_].to(torch.int64)
        if hi is not None and hi.shape[0] > 0:
            w = wide[lo:hi_]
            rows = hi_row[lo:hi_].clamp(0, hi.shape[0] - 1)
            wide_d = hi[rows].to(torch.int64) * 256 + (d & 0xFF)
            d = torch.where(w[:, None], wide_d, d)
        esc = torch.zeros((hi_ - lo, L + 1), dtype=torch.int64, device=d.device)
        esc.scatter_add_(1, ovf_pos[lo:hi_].to(torch.int64).clamp(0, L),
                         ovf_add[lo:hi_].to(torch.int64))
        vals = anchors[lo:hi_].to(torch.int64)[:, None] + torch.cumsum(d + esc[:, :L], 1)
        vals = (vals + (1 << 31)) % (1 << 32) - (1 << 31)
        out[lo:hi_] = vals.to(torch.int32)
    return out.reshape(-1)
