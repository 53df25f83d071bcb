"""Sorted segment sums: wrappers around the Hopper kernels, their launch
counters, and their plain PyTorch versions.

Counterpart of ``repro/kernels/segment_reduce.py:53`` (``segment_sum_sorted``),
``:109`` (``segment_sum_weighted_sorted``) and the chunked ``:229``, ``:271``,
``:410`` and ``:454``.  The kernels live in ``csrc/segment_reduce.cu``; see
its comments for the design (one edge-parallel pass over tiles of
``tile`` slots, then a fix-up launch for the rows that cross a tile
edge) and the bound.  The carries between the two live in a buffer kept
per stream (``_build.scratch``).  Each wrapper takes ``tile=``, one of
``TILES`` (default ``TILE``); ``ops`` passes the autotuner's winner for
the shape (``kernels/autotune.py``).  The plain versions take no tile,
and on the CPU the wrappers ignore it.  The GraphSAGE fanout reduce
(``:522`` ``fanout_aggregate``) is at the end, its kernel in
``csrc/fanout.cu``.

Contract (raw): ``dst`` int32 (E,) ascending, ``msg`` float32 (E, D),
``w`` float32 (E,); returns float32 (n_out, D) with
``out[d] = sum_{dst[e] == d} [w[e] *] msg[e]``.  Entries with
``dst >= n_out`` (padding, invalid edges) are dropped.  The chunked
kernels take dst as a ``core/compressed.ChunkedStream``'s arrays
(E = R * CHUNK) and compute the same function of the decoded lane, which
must be ascending; their plain versions decode and then reduce, and take
any lane.

Dispatch: a tensor on the CPU gets the plain version; a CUDA tensor gets
the kernel or an exception — never the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import compressed as cz
from . import _build, delta_decode

# Launches of each kernel in this process (bumped only where the kernel
# is launched, never by the plain versions).  A segment-sum call counts
# once: its C entry makes two CUDA launches, the pass and the fix-up.
LAUNCHES = {
    "segment_sum": 0,
    "segment_sum_weighted": 0,
    "segment_sum_chunked": 0,
    "segment_sum_weighted_chunked": 0,
    "segment_sum_chunked_adaptive": 0,
    "segment_sum_weighted_chunked_adaptive": 0,
    "fanout_aggregate": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# Slots a block of the segment-sum pass takes (kTile in csrc/segment_reduce.cu,
# built for each of TILES; TILE when no tile is named).
TILES = (2048, 4096, 8192)
TILE = 4096


def _check_tile(tile: int) -> int:
    if tile not in TILES:
        raise ValueError(f"tile must be one of {TILES}, got {tile}")
    return tile


def _scratch(E: int, D: int, device: torch.device, tile: int) -> torch.Tensor:
    """The carry buffer of a call over E slots: 2 int32 keys and 2 * D
    float32 values a tile, the values from the next 16-byte bound (the
    layout ``csrc/segment_reduce.cu``'s ``launch`` reads)."""
    tiles = -(-E // tile)
    return _build.scratch("segment_sum", device, -(-8 * tiles // 16) * 16 + 8 * tiles * D)


def _check_msg(E: int, msg: torch.Tensor, n_out: int, w: torch.Tensor | None) -> None:
    if msg.dtype != torch.float32 or msg.dim() != 2 or msg.shape[0] != E:
        raise TypeError(f"msg must be float32 (E, D) with E={E}, got "
                        f"{msg.dtype} {tuple(msg.shape)}")
    if w is not None and (w.dtype != torch.float32 or tuple(w.shape) != (E,)):
        raise TypeError(f"w must be float32 (E,), got {w.dtype} {tuple(w.shape)}")
    if n_out < 0 or n_out >= 2**31:
        raise ValueError(f"n_out out of int32 range: {n_out}")


def _check(dst: torch.Tensor, msg: torch.Tensor, n_out: int, w: torch.Tensor | None) -> None:
    if dst.dtype != torch.int32 or dst.dim() != 1:
        raise TypeError(f"dst must be int32 (E,), got {dst.dtype} {tuple(dst.shape)}")
    _check_msg(dst.shape[0], msg, n_out, w)
    _build.check_operands([dst, msg] + ([] if w is None else [w]))


def _plain(dst, msg, n_out, w=None):
    keep = (dst >= 0) & (dst < n_out)
    rows = msg[keep] if w is None else msg[keep] * w[keep][:, None]
    out = torch.zeros((n_out, msg.shape[1]), dtype=torch.float32, device=msg.device)
    return out.index_add_(0, dst[keep].long(), rows)


def segment_sum_sorted_plain(dst: torch.Tensor, msg: torch.Tensor, n_out: int) -> torch.Tensor:
    """Plain PyTorch version: drop ``dst >= n_out``, then ``index_add_``."""
    return _plain(dst, msg, n_out)


def segment_sum_weighted_sorted_plain(
    dst: torch.Tensor, w: torch.Tensor, msg: torch.Tensor, n_out: int
) -> torch.Tensor:
    """Plain PyTorch version of the weighted kernel."""
    return _plain(dst, msg, n_out, w)


def _launch(fn_name: str, counter: str, dst, w, msg, n_out: int, tile: int) -> torch.Tensor:
    E, D = msg.shape
    out = torch.empty((n_out, D), dtype=torch.float32, device=msg.device)
    head = [dst] + ([] if w is None else [w]) + [msg, out]
    tail = [ctypes.c_longlong(E), ctypes.c_int(D), ctypes.c_int(n_out), ctypes.c_int(tile)]
    _build.launch_with_scratch(
        lambda: _build.launch("segment_reduce", fn_name,
                              head + [_scratch(E, D, msg.device, tile)] + tail, msg.device),
        LAUNCHES, counter)
    return out


def segment_sum_sorted(dst: torch.Tensor, msg: torch.Tensor, n_out: int,
                       tile: int = TILE) -> torch.Tensor:
    """out[d, :] = sum of msg rows with dst == d (d < n_out)."""
    _check(dst, msg, n_out, None)
    _check_tile(tile)
    if dst.device.type == "cpu":
        return segment_sum_sorted_plain(dst, msg, n_out)
    return _launch("repro_segment_sum_sorted", "segment_sum", dst, None, msg, n_out, tile)


def segment_sum_weighted_sorted(
    dst: torch.Tensor, w: torch.Tensor, msg: torch.Tensor, n_out: int, tile: int = TILE
) -> torch.Tensor:
    """out[d, :] = sum of w[e] * msg[e, :] over edges with dst == d."""
    _check(dst, msg, n_out, w)
    _check_tile(tile)
    if dst.device.type == "cpu":
        return segment_sum_weighted_sorted_plain(dst, w, msg, n_out)
    return _launch("repro_segment_sum_weighted_sorted", "segment_sum_weighted", dst, w, msg,
                   n_out, tile)


# ---------------------------------------------------------------------------
# chunk-compressed dst lane
# ---------------------------------------------------------------------------


def _check_chunked(anchors, deltas, ovf_pos, ovf_add, msg, n_out, w=None, hi=None, wide=None):
    R = anchors.shape[0]
    if anchors.dtype != torch.int32 or anchors.dim() != 1 or R == 0:
        raise TypeError(f"anchors must be int32 (R,), R > 0, got {anchors.dtype} "
                        f"{tuple(anchors.shape)}")
    lane_types = (torch.int8,) if hi is not None else (torch.int8, torch.int16)
    if deltas.dtype not in lane_types or tuple(deltas.shape) != (R, cz.CHUNK):
        raise TypeError(f"deltas must be {lane_types} ({R}, {cz.CHUNK}), "
                        f"got {deltas.dtype} {tuple(deltas.shape)}")
    K = ovf_pos.shape[-1]
    for name, t in (("ovf_pos", ovf_pos), ("ovf_add", ovf_add)):
        if t.dtype != torch.int32 or tuple(t.shape) != (R, K):
            raise TypeError(f"{name} must be int32 ({R}, K), got {t.dtype} {tuple(t.shape)}")
    if K > 32:
        raise ValueError(f"at most 32 escape slots per chunk, got {K}")
    if hi is not None:
        if hi.dtype != torch.int8 or hi.dim() != 2 or hi.shape[1] != cz.CHUNK:
            raise TypeError(f"hi must be int8 (H, {cz.CHUNK}), got {hi.dtype} {tuple(hi.shape)}")
        if wide is None or wide.dtype != torch.bool or tuple(wide.shape) != (R,):
            raise TypeError(f"wide must be bool ({R},)")
    _check_msg(R * cz.CHUNK, msg, n_out, w)
    _build.check_operands([t for t in (anchors, deltas, ovf_pos, ovf_add, hi, wide, w, msg)
                           if t is not None])


def _decoded(anchors, deltas, ovf_pos, ovf_add, hi=None, wide=None) -> torch.Tensor:
    """The flat decoded lane by the decode's plain version (never its
    kernel, so a kernel here is held against plain code only)."""
    if hi is None:
        rows = delta_decode.delta_decode_chunked_plain(anchors, deltas, ovf_pos, ovf_add)
    else:
        rows = delta_decode.delta_decode_chunked_adaptive_plain(anchors, deltas, hi, wide,
                                                                ovf_pos, ovf_add)
    return rows.reshape(-1)


def segment_sum_sorted_chunked_plain(anchors, deltas, ovf_pos, ovf_add, msg, n_out, hi=None,
                                     wide=None) -> torch.Tensor:
    """Plain PyTorch version of the chunked kernels (fixed, or adaptive
    with ``hi``/``wide``): the plain decode, drop ``dst >= n_out``, then
    ``index_add_``."""
    return _plain(_decoded(anchors, deltas, ovf_pos, ovf_add, hi, wide), msg, n_out)


def segment_sum_weighted_chunked_plain(anchors, deltas, ovf_pos, ovf_add, w, msg, n_out,
                                       hi=None, wide=None) -> torch.Tensor:
    """Plain PyTorch version of the weighted chunked kernels."""
    return _plain(_decoded(anchors, deltas, ovf_pos, ovf_add, hi, wide), msg, n_out, w)


# (weighted, adaptive) -> (launch counter, C entry point)
_CHUNKED = {
    (False, False): ("segment_sum_chunked", "repro_segment_sum_sorted_chunked"),
    (True, False): ("segment_sum_weighted_chunked", "repro_segment_sum_weighted_chunked"),
    (False, True): ("segment_sum_chunked_adaptive", "repro_segment_sum_sorted_chunked_adaptive"),
    (True, True): ("segment_sum_weighted_chunked_adaptive",
                   "repro_segment_sum_weighted_chunked_adaptive"),
}


def _launch_chunked(anchors, deltas, ovf_pos, ovf_add, w, msg, n_out, hi, wide,
                    tile) -> torch.Tensor:
    adaptive, weighted = hi is not None, w is not None
    counter, fn_name = _CHUNKED[(weighted, adaptive)]
    delta_decode.check_lane_aligned(deltas, hi)  # the shared decode_row's vector loads
    R, K = ovf_pos.shape
    D = msg.shape[1]
    out = torch.empty((n_out, D), dtype=torch.float32, device=msg.device)
    args = [anchors, deltas]
    if adaptive:
        hi_row = delta_decode.hi_rows(wide, hi.shape[0])  # O(R); no (R, CHUNK) gathered plane
        args += [hi, wide, hi_row, ctypes.c_int(hi.shape[0])]
    else:
        args += [ctypes.c_int(deltas.element_size())]
    args += [ovf_pos, ovf_add] + ([w] if weighted else [])
    args += [msg, out]
    tail = [ctypes.c_longlong(R), ctypes.c_int(K), ctypes.c_int(D), ctypes.c_int(n_out),
            ctypes.c_int(tile)]
    _build.launch_with_scratch(
        lambda: _build.launch("segment_reduce", fn_name,
                              args + [_scratch(R * cz.CHUNK, D, msg.device, tile)] + tail,
                              msg.device),
        LAUNCHES, counter)
    return out


def segment_sum_sorted_chunked(anchors, deltas, ovf_pos, ovf_add, msg, n_out,
                               tile: int = TILE) -> torch.Tensor:
    """``segment_sum_sorted`` over a fixed-width chunked dst lane (int8 or
    int16 deltas with escapes), decoded inside the kernel."""
    _check_chunked(anchors, deltas, ovf_pos, ovf_add, msg, n_out)
    _check_tile(tile)
    if msg.device.type == "cpu":
        return segment_sum_sorted_chunked_plain(anchors, deltas, ovf_pos, ovf_add, msg, n_out)
    return _launch_chunked(anchors, deltas, ovf_pos, ovf_add, None, msg, n_out, None, None, tile)


def segment_sum_weighted_chunked(anchors, deltas, ovf_pos, ovf_add, w, msg, n_out,
                                 tile: int = TILE) -> torch.Tensor:
    """Weighted ``segment_sum_sorted_chunked``."""
    _check_chunked(anchors, deltas, ovf_pos, ovf_add, msg, n_out, w=w)
    _check_tile(tile)
    if msg.device.type == "cpu":
        return segment_sum_weighted_chunked_plain(anchors, deltas, ovf_pos, ovf_add, w, msg, n_out)
    return _launch_chunked(anchors, deltas, ovf_pos, ovf_add, w, msg, n_out, None, None, tile)


def segment_sum_sorted_chunked_adaptive(anchors, deltas, hi, wide, ovf_pos, ovf_add, msg,
                                        n_out, tile: int = TILE) -> torch.Tensor:
    """``segment_sum_sorted_chunked`` over the adaptive layout: int8 lane,
    compacted hi plane ``hi`` (H, CHUNK) and per-chunk tags ``wide``."""
    _check_chunked(anchors, deltas, ovf_pos, ovf_add, msg, n_out, hi=hi, wide=wide)
    _check_tile(tile)
    if msg.device.type == "cpu":
        return segment_sum_sorted_chunked_plain(anchors, deltas, ovf_pos, ovf_add, msg, n_out,
                                                hi, wide)
    return _launch_chunked(anchors, deltas, ovf_pos, ovf_add, None, msg, n_out, hi, wide, tile)


def segment_sum_weighted_chunked_adaptive(anchors, deltas, hi, wide, ovf_pos, ovf_add, w, msg,
                                          n_out, tile: int = TILE) -> torch.Tensor:
    """Weighted ``segment_sum_sorted_chunked_adaptive``."""
    _check_chunked(anchors, deltas, ovf_pos, ovf_add, msg, n_out, w=w, hi=hi, wide=wide)
    _check_tile(tile)
    if msg.device.type == "cpu":
        return segment_sum_weighted_chunked_plain(anchors, deltas, ovf_pos, ovf_add, w, msg,
                                                  n_out, hi, wide)
    return _launch_chunked(anchors, deltas, ovf_pos, ovf_add, w, msg, n_out, hi, wide, tile)


# ---------------------------------------------------------------------------
# fixed-fanout aggregation (sampled GNN regime: GraphSAGE minibatch)
# ---------------------------------------------------------------------------

FANOUT_OPS = ("sum", "mean", "max")


def _check_fanout(feats: torch.Tensor, mask: torch.Tensor, op: str) -> None:
    if op not in FANOUT_OPS:
        raise ValueError(f"op must be one of {FANOUT_OPS}, got {op!r}")
    if feats.dtype != torch.float32 or feats.dim() != 3:
        raise TypeError(f"feats must be float32 (B, K, D), got {feats.dtype} "
                        f"{tuple(feats.shape)}")
    B, K, _ = feats.shape
    if mask.dtype != torch.float32 or tuple(mask.shape) != (B, K):
        raise TypeError(f"mask must be float32 ({B}, {K}), got {mask.dtype} "
                        f"{tuple(mask.shape)}")
    if K == 0:
        raise ValueError("fanout_aggregate needs at least one sampled neighbour (K >= 1)")
    _build.check_operands([feats, mask])


def fanout_aggregate_plain(feats: torch.Tensor, mask: torch.Tensor, op: str = "mean"):
    """Plain PyTorch version: ``m`` the mask as float32; sum
    ``sum_k f*m``, mean ``sum_k f*m / max(sum_k m, 1)``, max over
    ``m > 0`` with ``finfo(float32).min`` for masked entries."""
    m = mask[..., None]
    if op == "max":
        return torch.where(m > 0, feats, torch.finfo(torch.float32).min).amax(1)
    s = (feats * m).sum(1)
    if op == "sum":
        return s
    return s / torch.clamp(m.sum(1), min=1.0)


def fanout_aggregate(feats: torch.Tensor, mask: torch.Tensor, op: str = "mean") -> torch.Tensor:
    """Masked ``op`` over the K sampled neighbours: float32 (B, K, D) and
    a float32 (B, K) mask -> float32 (B, D).  Any B (no padding)."""
    _check_fanout(feats, mask, op)
    if feats.device.type == "cpu":
        return fanout_aggregate_plain(feats, mask, op)
    B, K, D = feats.shape
    out = torch.empty((B, D), dtype=torch.float32, device=feats.device)
    args = [feats, mask, out, ctypes.c_longlong(B), ctypes.c_int(K), ctypes.c_int(D),
            ctypes.c_int(FANOUT_OPS.index(op))]
    _build.launch("fanout", "repro_fanout_aggregate", args, feats.device)
    LAUNCHES["fanout_aggregate"] += 1
    return out
