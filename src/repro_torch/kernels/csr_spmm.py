"""Block-dense SpMM (``A @ X`` over dense tiles of A) for full-graph GNNs:
the wrapper around the Hopper kernel, its launch counter, its plain
PyTorch version, and the host tile builder.

Counterpart of ``repro/kernels/csr_spmm.py`` (``block_spmm`` at ``:47``,
``tiles_from_edges`` at ``:70``).  The kernel lives in
``csrc/block_spmm.cu``; see its comments for the design (compact each
live tile's nonzeros, then gather them per output row) and the bound.

Contract: ``tile_mask`` int32 (nr, nc), ``a_tiles`` float32
(nr, nc, R, C) with R = C = 128, ``x`` float32 (n_x, D) with
n_x <= nc * C; returns
float32 (nr * R, D) with
``out[i*R:(i+1)*R] = sum_j [tile_mask[i, j] > 0] * a_tiles[i, j] @ x[j*C:(j+1)*C]``
and rows of x at or past n_x read as zero (the reference pads x to whole
tiles).  A tile whose mask is 0 contributes nothing even if it holds
nonzeros, as the TPU kernel skips it; the reference's oracle
``block_spmm_ref`` un-tiles every tile instead.  float32 throughout, as
the reference runs at ``Precision.HIGHEST``: no TF32.  The reference
asks its autotuner for the tile sizes; until the port has one (ROADMAP
item 13) they are fixed at ROW_TILE = COL_TILE = 128, and the wrapper
rejects any other.

Zero entries of A are left out of the kernel's sum, which runs over each
output element's terms in ascending (tile column, column) order: the same
bits on every call.  For finite x that matches the dense product to
float32 rounding (a skipped term changes at most the sign of a zero).
For non-finite x the two differ: the plain version's dense product gives
``0 * inf = NaN`` where A holds a zero, the kernel leaves the term out.

The kernel takes a workspace of ``workspace_bytes(nr, nc)`` bytes (one
slot per tile: 129 row offsets and up to 128 * 128 (column, value)
pairs), a buffer the wrapper keeps per stream (``_build.scratch``) and
grows when a call needs more.

The dense tile layout grows as n^2: Reddit's 232,965 vertices would need
about 217 TB of tiles, so this path is for Cora-sized graphs (2,708
vertices: 22 x 22 tiles of 128 x 128, 31.7 MB).

Dispatch: a tensor on the CPU gets the plain version; a CUDA tensor gets
the kernel or an exception — never the plain version.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

ROW_TILE = 128
COL_TILE = 128

# Launches of the kernel in this process (bumped only where it launches).
LAUNCHES = {"block_spmm": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(tile_mask: torch.Tensor, a_tiles: torch.Tensor, x: torch.Tensor) -> None:
    if a_tiles.dtype != torch.float32 or a_tiles.dim() != 4:
        raise TypeError(f"a_tiles must be float32 (nr, nc, R, C), got {a_tiles.dtype} "
                        f"{tuple(a_tiles.shape)}")
    nr, nc, R, C = a_tiles.shape
    if (R, C) != (ROW_TILE, COL_TILE):
        raise ValueError(f"block_spmm takes {ROW_TILE} x {COL_TILE} tiles, got {R} x {C}")
    if tile_mask.dtype != torch.int32 or tuple(tile_mask.shape) != (nr, nc):
        raise TypeError(f"tile_mask must be int32 ({nr}, {nc}), got {tile_mask.dtype} "
                        f"{tuple(tile_mask.shape)}")
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"x must be float32 (n_x, D), got {x.dtype} {tuple(x.shape)}")
    if x.shape[0] > nc * C:
        raise ValueError(f"x has {x.shape[0]} rows, more than the tiles' {nc} x {C} columns")
    if nr * R >= 2**31 or nc * C >= 2**31 or x.shape[1] >= 2**31:
        raise ValueError("block_spmm shapes out of int32 range")
    _build.check_operands([tile_mask, a_tiles, x])


# One tile's workspace slot (csrc/block_spmm.cu): 132 int32 row offsets
# (129 used, padded to 16 bytes), then ROW_TILE * COL_TILE (int32 column,
# float32 value) pairs.
SLOT_BYTES = 4 * 132 + 8 * ROW_TILE * COL_TILE

_P, _I = ctypes.c_void_p, ctypes.c_int
# repro_block_spmm_compact(mask, tiles, work, nr, nc, stream) and
# repro_block_spmm_gather(mask, work, x, out, nr, nc, n_x, D, stream)
_COMPACT = [_P, _P, _P, _I, _I, _P]
_GATHER = [_P, _P, _P, _P, _I, _I, ctypes.c_longlong, _I, _P]


def workspace_bytes(nr: int, nc: int) -> int:
    """Bytes of workspace the kernel takes for nr x nc tiles: one slot
    per tile, sized from the shapes alone."""
    return nr * nc * SLOT_BYTES


def block_spmm_plain(tile_mask: torch.Tensor, a_tiles: torch.Tensor,
                     x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: zero the masked-off tiles, un-tile A, pad x
    with zero rows to nc * C, one dense float32 product."""
    nr, nc, R, C = a_tiles.shape
    live = (tile_mask > 0)[:, :, None, None]
    a = torch.where(live, a_tiles, 0.0).permute(0, 2, 1, 3).reshape(nr * R, nc * C)
    xp = x.new_zeros((nc * C, x.shape[1]))
    xp[: x.shape[0]] = x
    return a @ xp


def block_spmm(tile_mask: torch.Tensor, a_tiles: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Sum over the unmasked tiles of ``a_tiles[i, j] @ x[j*C:(j+1)*C]``
    per row tile i: float32 (nr * R, D)."""
    _check(tile_mask, a_tiles, x)
    if x.device.type == "cpu":
        return block_spmm_plain(tile_mask, a_tiles, x)
    if a_tiles.data_ptr() % 16:
        raise ValueError("block_spmm: a_tiles must start on a 16-byte boundary")
    nr, nc = tile_mask.shape
    n_x, D = x.shape
    dev = x.device.index
    work = _build.scratch("block_spmm", x.device, workspace_bytes(nr, nc)).data_ptr()
    # the compaction runs while the output is allocated
    _build.call(_build.c_function("block_spmm", "repro_block_spmm_compact", _COMPACT),
                "repro_block_spmm_compact",
                [tile_mask.data_ptr(), a_tiles.data_ptr(), work, nr, nc], dev)
    out = torch.empty((nr * ROW_TILE, D), dtype=torch.float32, device=x.device)
    _build.call(_build.c_function("block_spmm", "repro_block_spmm_gather", _GATHER),
                "repro_block_spmm_gather",
                [tile_mask.data_ptr(), work, x.data_ptr(), out.data_ptr(), nr, nc, n_x, D], dev)
    LAUNCHES["block_spmm"] += 1
    return out


def tiles_from_edges(n: int, src, dst, vals=None):
    """Host-side: ``(tile_mask int32 (nr, nc), a_tiles float32
    (nr, nc, 128, 128), n_pad)`` as numpy arrays from an edge list, in
    the ``A[dst, src]`` layout (messages flow src -> dst); duplicate
    (dst, src) pairs accumulate.  Bit-identical to the reference's
    builder at its 128 x 128 tiles; the caller moves the tiles to the
    device."""
    R, C = ROW_TILE, COL_TILE
    n_pad = int(np.ceil(n / R)) * R
    nr, nc = n_pad // R, n_pad // C
    a = np.zeros((nr, nc, R, C), dtype=np.float32)
    v = np.ones(len(src), dtype=np.float32) if vals is None else np.asarray(vals, np.float32)
    r, c = np.asarray(dst), np.asarray(src)
    np.add.at(a, (r // R, c // C, r % R, c % C), v)
    mask = (np.abs(a).sum(axis=(2, 3)) > 0).astype(np.int32)
    return mask, a, n_pad
