"""Oracles for the port's kernels (the correctness contracts).

Counterpart of ``repro/kernels/ref.py:13-71``.  Each oracle
computes the kernel's function the most direct way — a float64
scatter-add, no sortedness assumed; a decode as anchor + cumsum plus one
step per escape; a float64 masked reduce; a float64 masked softmax; a
dense float64 product — so tests can hold both the kernel and its plain
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


def fanout_aggregate_ref(feats: torch.Tensor, mask: torch.Tensor, op: str = "mean") -> torch.Tensor:
    """Masked reduce over axis 1 of (B, K, D) with ``m`` the mask as a
    number: sum ``sum f*m``, mean ``sum f*m / max(sum m, 1)``, max over
    ``m > 0`` with ``finfo(float32).min`` for masked entries (float64)."""
    f = feats.double()
    m = mask.double()[..., None]
    if op == "sum":
        return (f * m).sum(1)
    if op == "mean":
        return (f * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
    return torch.where(m > 0, f, float(torch.finfo(torch.float32).min)).amax(1)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Masked softmax attention (float64), cast to q's dtype.  Like the
    reference's oracle it has no guard: a row of length 0 is a softmax
    over nothing and gives NaN, where the kernel gives 0."""
    qf, kf, vf = q.double(), k.double(), v.double()
    s = torch.einsum("bqd,bsd->bqs", qf, kf) / (q.shape[-1] ** 0.5)
    pos = torch.arange(k.shape[1], device=k.device)
    s = torch.where(pos[None, None, :] < lengths.long()[:, None, None], s, -torch.inf)
    return torch.einsum("bqs,bsd->bqd", torch.softmax(s, dim=-1), vf).to(q.dtype)


def block_spmm_ref(tile_mask: torch.Tensor, a_tiles: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Un-tile A and do the dense product (float64).  Like the reference's
    oracle it reads every tile and ignores ``tile_mask``; the kernel and
    its plain version skip masked-off tiles, so the two agree when the
    mask is the nonzero pattern (as ``tiles_from_edges`` builds it)."""
    nr, nc, R, C = a_tiles.shape
    a = a_tiles.double().permute(0, 2, 1, 3).reshape(nr * R, nc * C)
    return a @ x.double()
