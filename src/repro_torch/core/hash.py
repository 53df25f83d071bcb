"""Uniform hash family for C-tree head selection (paper §3.1).

Counterpart of ``repro/core/hash.py``.  The numpy half is copied as it
is (the host C-tree chunks with it).  The torch half computes the same
murmur3 fmix32 bit for bit: torch's uint32 support is thin, so lanes are
held in int64 and every multiply is taken modulo 2^32 (``_mul32``), which
is exactly uint32 wraparound.
"""
from __future__ import annotations

import numpy as np
import torch

_DEFAULT_SEED = np.uint32(0x9E3779B9)
_MASK32 = 0xFFFFFFFF


def hash32_np(x: np.ndarray, seed: int | np.uint32 = _DEFAULT_SEED) -> np.ndarray:
    """murmur3 fmix32 over uint32 lanes (numpy). uint32 wraparound is the
    point of the mix, so overflow warnings are suppressed locally."""
    with np.errstate(over="ignore"):
        h = (np.asarray(x).astype(np.uint64) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        h ^= np.uint32(seed)
        h ^= h >> np.uint32(16)
        h = (h * np.uint32(0x85EBCA6B)).astype(np.uint32)
        h ^= h >> np.uint32(13)
        h = (h * np.uint32(0xC2B2AE35)).astype(np.uint32)
        h ^= h >> np.uint32(16)
    return h


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h, c < 2^32, split in 16-bit halves of c so no
    int64 product overflows."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


def hash32_torch(x: torch.Tensor, seed: int = int(_DEFAULT_SEED)) -> torch.Tensor:
    """murmur3 fmix32 (identical to ``hash32_np``); int64 lanes holding
    the uint32 value.  Inputs are reduced to their low 32 bits first, as
    ``astype(uint32)`` does."""
    h = x.to(torch.int64) & _MASK32
    h = h ^ (int(seed) & _MASK32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def is_head_np(x: np.ndarray, b: int, seed: int | np.uint32 = _DEFAULT_SEED) -> np.ndarray:
    """Head predicate h(e) mod b == 0.  ``b`` need not be a power of two,
    but powers of two are cheapest (mask instead of mod)."""
    h = hash32_np(x, seed)
    if b & (b - 1) == 0:
        return (h & np.uint32(b - 1)) == 0
    return (h % np.uint32(b)) == 0


def is_head_torch(x: torch.Tensor, b: int, seed: int = int(_DEFAULT_SEED)) -> torch.Tensor:
    h = hash32_torch(x, seed)
    if b & (b - 1) == 0:
        return (h & (b - 1)) == 0
    return (h % b) == 0


def priority_np(x, seed: int | np.uint32 = _DEFAULT_SEED):
    """Treap priorities for the head tree (an independent member of the family)."""
    return hash32_np(np.asarray(x), np.uint32(seed) ^ np.uint32(0xDEADBEEF))

