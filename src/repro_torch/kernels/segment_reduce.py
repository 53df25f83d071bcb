"""Sorted segment sums: wrappers around the Hopper kernels, their launch
counters, and their plain PyTorch versions.

Counterpart of ``repro/kernels/segment_reduce.py:53`` (``segment_sum_sorted``)
and ``:109`` (``segment_sum_weighted_sorted``).  The kernels live in
``csrc/segment_reduce.cu``; see its header for the design and its bound.

Contract (both): ``dst`` int32 (E,) ascending, ``msg`` float32 (E, D),
``w`` float32 (E,); returns float32 (n_out, D) with
``out[d] = sum_{dst[e] == d} [w[e] *] msg[e]``.  Entries with
``dst >= n_out`` (padding, invalid edges) are dropped.

Dispatch: a tensor on the CPU gets the plain version; a CUDA tensor gets
the kernel or an exception — never the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# Launches of each kernel in this process (bumped only where the kernel
# is launched, never by the plain versions).
LAUNCHES = {"segment_sum": 0, "segment_sum_weighted": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(dst: torch.Tensor, msg: torch.Tensor, n_out: int, w: torch.Tensor | None) -> None:
    if dst.dtype != torch.int32 or dst.dim() != 1:
        raise TypeError(f"dst must be int32 (E,), got {dst.dtype} {tuple(dst.shape)}")
    if msg.dtype != torch.float32 or msg.dim() != 2 or msg.shape[0] != dst.shape[0]:
        raise TypeError(f"msg must be float32 (E, D) with E={dst.shape[0]}, got "
                        f"{msg.dtype} {tuple(msg.shape)}")
    if w is not None and (w.dtype != torch.float32 or tuple(w.shape) != tuple(dst.shape)):
        raise TypeError(f"w must be float32 (E,), got {w.dtype} {tuple(w.shape)}")
    if n_out < 0 or n_out >= 2**31:
        raise ValueError(f"n_out out of int32 range: {n_out}")
    tensors = [dst, msg] + ([] if w is None else [w])
    if len({t.device for t in tensors}) != 1:
        raise ValueError("dst, msg and w must be on one device")
    if dst.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dst.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("dst, msg and w must be contiguous")


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


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _launch(fn_name: str, counter: str, dst, w, msg, n_out: int) -> torch.Tensor:
    lib = _build.library("segment_reduce")
    fn = getattr(lib, fn_name)
    E, D = msg.shape
    out = torch.empty((n_out, D), dtype=torch.float32, device=msg.device)
    bounds = torch.empty(n_out + 1, dtype=torch.int64, device=msg.device)  # scratch
    stream = torch.cuda.current_stream(msg.device).cuda_stream
    ptrs = [_ptr(dst)] + ([] if w is None else [_ptr(w)]) + [_ptr(msg), _ptr(out), _ptr(bounds)]
    fn.argtypes = [ctypes.c_void_p] * len(ptrs) + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(msg.device):
        rc = fn(*ptrs, E, D, n_out, ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"{fn_name} launch failed: cudaError {rc}")
    LAUNCHES[counter] += 1
    return out


def segment_sum_sorted(dst: torch.Tensor, msg: torch.Tensor, n_out: int) -> torch.Tensor:
    """out[d, :] = sum of msg rows with dst == d (d < n_out)."""
    _check(dst, msg, n_out, None)
    if dst.device.type == "cpu":
        return segment_sum_sorted_plain(dst, msg, n_out)
    return _launch("repro_segment_sum_sorted", "segment_sum", dst, None, msg, n_out)


def segment_sum_weighted_sorted(
    dst: torch.Tensor, w: torch.Tensor, msg: torch.Tensor, n_out: int
) -> torch.Tensor:
    """out[d, :] = sum of w[e] * msg[e, :] over edges with dst == d."""
    _check(dst, msg, n_out, w)
    if dst.device.type == "cpu":
        return segment_sum_weighted_sorted_plain(dst, w, msg, n_out)
    return _launch("repro_segment_sum_weighted_sorted", "segment_sum_weighted", dst, w, msg, n_out)
