"""Chunk delta decode: wrappers around the Hopper kernels, their launch
counters, and their plain PyTorch versions.

Counterpart of ``repro/kernels/delta_decode.py:83`` (``delta_decode_chunked``),
``:162`` (``delta_decode_chunked_adaptive``) and ``:210``
(``delta_decode_padded``).  The kernels live in ``csrc/delta_decode.cu``;
see its comments for the design and the bound.

Contracts (all int32, wrapping in 32 bits as an int32 cumsum does):

- padded: ``anchors`` (R,), ``deltas`` (R, L) -> (R, L),
  ``out[i, j] = anchors[i] + sum(deltas[i, :j + 1])``; any R >= 0, L >= 0.
- chunked: a ``core/compressed.ChunkedStream``'s arrays, ``deltas`` int8 or
  int16 (R, L) with column 0 == 0, escapes ``ovf_pos``/``ovf_add`` (R, K):
  ``out[i, j] = anchors[i] + sum(deltas[i, :j + 1]) + sum_k ovf_add[i, k]
  * 1[j >= ovf_pos[i, k]]`` (a column past the row never acts).  The
  adaptive form takes an int8 lane, the compacted hi plane ``hi`` (H, L)
  and the tags ``wide`` (R,), and reads a wide chunk's delta as
  ``hi * 256 + (lane & 0xFF)``.  The kernels take L == 128 (the stream's
  chunk) and K <= 32; the plain versions take any L and K.

Dispatch: a tensor on the CPU gets the plain version; a CUDA tensor gets
the kernel or an exception — never the plain version.  On the card a
chunked call makes no torch op but the output's allocation, and counts
one launch: one CUDA launch for a fixed width, two for the adaptive form
(a pre-pass finds each tile's first hi row by a look-back over the wide
tags, then the decode), whose buffer is kept per stream
(``_build.scratch``) with a new epoch each call (so a CUDA graph must not
capture it: a replay would repeat the epoch).

This module imports nothing from ``core``: ``core/compressed.decode_rows``
calls it, and ``kernels/segment_reduce`` imports ``core/compressed``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

KERNEL_CHUNK = 128  # chunk row the CUDA kernels decode (a warp, 4 slots per lane)
KERNEL_MAX_SLOTS = 32  # escape slots per row: one per lane
KERNEL_MAX_ROWS = 2**30  # the look-back counts wide chunks in 30 bits

# Launches of each kernel in this process (bumped only where the kernel
# is launched, never by the plain versions).
LAUNCHES = {
    "delta_decode_padded": 0,
    "delta_decode_chunked": 0,
    "delta_decode_chunked_adaptive": 0,
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def hi_rows(wide: torch.Tensor, hi_cap: int) -> torch.Tensor:
    """int32[R] row of each chunk's high bytes in the compacted plane:
    ``cumsum(wide) - 1``, clamped into ``[0, hi_cap)`` (narrow chunks
    never read it)."""
    idx = torch.cumsum(wide.to(torch.int32), 0, dtype=torch.int32) - 1
    return idx.clamp_(0, max(hi_cap - 1, 0))


def adaptive_deltas(deltas: torch.Tensor, hi: torch.Tensor, wide: torch.Tensor) -> torch.Tensor:
    """Per-slot int32 deltas of an adaptive lane (escapes still 0): the
    width select ``wide ? hi * 256 + (lane & 0xFF) : lane``."""
    lane = deltas.to(torch.int32)
    if hi.shape[0] == 0:
        # no wide chunk can exist without spilling; the lane is exact
        return lane
    hi_g = hi.to(torch.int32)[hi_rows(wide, hi.shape[0]).long()]
    return torch.where(wide[:, None], hi_g * 256 + (lane & 0xFF), lane)


def _decode_escaped(anchors: torch.Tensor, d: torch.Tensor, ovf_pos: torch.Tensor,
                    ovf_add: torch.Tensor) -> torch.Tensor:
    """anchor + row cumsum of int32 deltas ``d``, with each escape's delta
    added at its column first (equal to the per-column step corrections;
    integer sums are exact)."""
    R, L = d.shape
    steps = torch.zeros((R, L + 1), dtype=torch.int32, device=d.device)
    pos = ovf_pos.long().clamp(0, L)  # columns past the row hit the sink column
    steps.scatter_add_(1, pos, ovf_add.to(torch.int32))
    d = d + steps[:, :L]
    return anchors[:, None] + torch.cumsum(d, dim=1, dtype=torch.int32)


def delta_decode_padded_plain(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: anchor + int32 row cumsum."""
    return anchors[:, None] + torch.cumsum(deltas, dim=1, dtype=torch.int32)


def delta_decode_chunked_plain(anchors, deltas, ovf_pos, ovf_add) -> torch.Tensor:
    """Plain PyTorch version of the fixed-width chunked kernel."""
    return _decode_escaped(anchors, deltas.to(torch.int32), ovf_pos, ovf_add)


def delta_decode_chunked_adaptive_plain(anchors, deltas, hi, wide, ovf_pos,
                                        ovf_add) -> torch.Tensor:
    """Plain PyTorch version of the adaptive chunked kernel."""
    return _decode_escaped(anchors, adaptive_deltas(deltas, hi, wide), ovf_pos, ovf_add)


# ---------------------------------------------------------------------------
# checks and launches
# ---------------------------------------------------------------------------


def _check_rows(anchors: torch.Tensor, deltas: torch.Tensor, lane_types) -> tuple:
    if anchors.dtype != torch.int32 or anchors.dim() != 1:
        raise TypeError(f"anchors must be int32 (R,), got {anchors.dtype} {tuple(anchors.shape)}")
    R = anchors.shape[0]
    if deltas.dtype not in lane_types or deltas.dim() != 2 or deltas.shape[0] != R:
        raise TypeError(f"deltas must be {lane_types} ({R}, L), got {deltas.dtype} "
                        f"{tuple(deltas.shape)}")
    return R, deltas.shape[1]


def _check_chunked(anchors, deltas, ovf_pos, ovf_add, hi=None, wide=None) -> torch.device:
    lane_types = (torch.int8,) if hi is not None else (torch.int8, torch.int16)
    R, L = _check_rows(anchors, deltas, lane_types)
    K = ovf_pos.shape[-1] if ovf_pos.dim() == 2 else -1
    for name, t in (("ovf_pos", ovf_pos), ("ovf_add", ovf_add)):
        if t.dtype != torch.int32 or tuple(t.shape) != (R, K):
            raise TypeError(f"{name} must be int32 ({R}, K), got {t.dtype} {tuple(t.shape)}")
    if hi is not None:
        if hi.dtype != torch.int8 or hi.dim() != 2 or hi.shape[1] != L:
            raise TypeError(f"hi must be int8 (H, {L}), got {hi.dtype} {tuple(hi.shape)}")
        if wide is None or wide.dtype != torch.bool or tuple(wide.shape) != (R,):
            raise TypeError(f"wide must be bool ({R},)")
    dev = _build.check_operands([t for t in (anchors, deltas, ovf_pos, ovf_add, hi, wide)
                                 if t is not None])
    if dev.type == "cuda":
        if L != KERNEL_CHUNK or K > KERNEL_MAX_SLOTS or R >= KERNEL_MAX_ROWS:
            raise ValueError(f"the chunked decode kernel takes rows of {KERNEL_CHUNK} slots, at "
                             f"most {KERNEL_MAX_SLOTS} escape slots and fewer than "
                             f"{KERNEL_MAX_ROWS} rows, got L={L}, K={K}, R={R}")
        check_lane_aligned(deltas, hi, wide)
    return dev


def check_lane_aligned(deltas: torch.Tensor, hi: torch.Tensor | None = None,
                       wide: torch.Tensor | None = None) -> None:
    """The kernels load a lane's 4 deltas as one 32-bit (int8) or 64-bit
    (int16) word and its 4 hi bytes as one 32-bit word, and the adaptive
    decode's pre-pass reads the tags 16 at a time: raises unless the bases
    are so aligned (whole rows, and tensors as allocated, keep it)."""
    if (deltas.data_ptr() % (4 * deltas.element_size()) or (hi is not None and hi.data_ptr() % 4)
            or (wide is not None and wide.data_ptr() % 16)):
        raise ValueError("the chunked kernels need the delta lane aligned to 4 deltas, the hi "
                         "plane to 4 bytes and the wide tags to 16")


_PLAN: dict[str, int] = {}  # the chunked kernels' tile, read from the library once


def chunked_plan() -> dict[str, int]:
    """``{"rows_per_warp", "rows_per_block", "rows_per_prefix_block"}`` of
    the chunked kernels (the last: rows whose tags a block of the adaptive
    pre-pass counts; the library is built on first use)."""
    if not _PLAN:
        fn = _build.c_function("delta_decode", "repro_delta_decode_chunked_plan",
                               [ctypes.c_void_p] * 3)
        vals = [ctypes.c_int() for _ in range(3)]
        fn(*map(ctypes.byref, vals))
        _PLAN.update(zip(("rows_per_warp", "rows_per_block", "rows_per_prefix_block"),
                         (v.value for v in vals)))
    return _PLAN


_EPOCH = [0]  # the last look-back epoch handed out (status words of older calls differ)


def _lookback(R: int, device: torch.device) -> list:
    """The adaptive decode's look-back arguments: this stream's buffer (a
    16-byte ticket counter, a status word per 256 tiles and a prefix per
    tile, within 12 B a tile; zero when made, and the counter left zero by
    every call) and a new nonzero epoch.  When the 32-bit epoch would wrap,
    every buffer is dropped, so the next ones start zeroed."""
    _EPOCH[0] += 1
    if _EPOCH[0] >= 2**32:
        _build.drop_scratch("decode_lookback")
        _EPOCH[0] = 1
    tiles = -(-R // chunked_plan()["rows_per_block"])
    buf = _build.scratch("decode_lookback", device, 16 + 12 * tiles, zeroed=True)
    return [buf, ctypes.c_uint(_EPOCH[0])]


def _launch(fn_name: str, counter: str, args: list, out: torch.Tensor) -> torch.Tensor:
    _build.launch("delta_decode", fn_name, args, out.device)
    LAUNCHES[counter] += 1
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def delta_decode_padded(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """int32 (R, L): ``anchors[i] + inclusive_cumsum(deltas[i, :])``."""
    R, L = _check_rows(anchors, deltas, (torch.int32,))
    if L >= 2**31 - 2 * KERNEL_CHUNK:
        raise ValueError(f"row length out of range: {L}")
    if _build.check_operands([anchors, deltas]).type == "cpu":
        return delta_decode_padded_plain(anchors, deltas)
    out = torch.empty((R, L), dtype=torch.int32, device=deltas.device)
    if out.numel() == 0:
        return out  # nothing to launch
    return _launch("repro_delta_decode_padded", "delta_decode_padded",
                   [anchors, deltas, out, ctypes.c_longlong(R), ctypes.c_int(L)], out)


def delta_decode_chunked(anchors, deltas, ovf_pos, ovf_add) -> torch.Tensor:
    """int32 (R, L) decode of fixed-width (int8 or int16) chunk rows with
    an escape lane."""
    if _check_chunked(anchors, deltas, ovf_pos, ovf_add).type == "cpu":
        return delta_decode_chunked_plain(anchors, deltas, ovf_pos, ovf_add)
    R, K = ovf_pos.shape
    out = torch.empty(tuple(deltas.shape), dtype=torch.int32, device=deltas.device)
    if R == 0:
        return out
    return _launch("repro_delta_decode_chunked", "delta_decode_chunked",
                   [anchors, deltas, ctypes.c_int(deltas.element_size()), ovf_pos, ovf_add,
                    out, ctypes.c_longlong(R), ctypes.c_int(K)], out)


def delta_decode_chunked_adaptive(anchors, deltas, hi, wide, ovf_pos, ovf_add) -> torch.Tensor:
    """int32 (R, L) decode of adaptive chunk rows: int8 lane, compacted hi
    plane ``hi`` (H, L) and per-chunk tags ``wide``."""
    if _check_chunked(anchors, deltas, ovf_pos, ovf_add, hi, wide).type == "cpu":
        return delta_decode_chunked_adaptive_plain(anchors, deltas, hi, wide, ovf_pos, ovf_add)
    R, K = ovf_pos.shape
    out = torch.empty(tuple(deltas.shape), dtype=torch.int32, device=deltas.device)
    if R == 0:
        return out
    args = [anchors, deltas, hi, wide, ctypes.c_int(hi.shape[0]), ovf_pos, ovf_add, out,
            ctypes.c_longlong(R), ctypes.c_int(K)]
    _build.launch_with_scratch(  # the epoch and this stream's look-back buffer
        lambda: _build.launch("delta_decode", "repro_delta_decode_chunked_adaptive",
                              args + _lookback(R, out.device), out.device),
        LAUNCHES, "delta_decode_chunked_adaptive")
    return out
