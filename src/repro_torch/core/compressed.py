"""Chunked delta encoding on the device (the compressed pool lane).

Counterpart of ``repro/core/compressed.py``.  The paper stores graphs at
a few bytes per edge by chunking each C-tree and difference-encoding
within chunks (§3.2).  On the device the layout is a sorted-ish int32
stream cut into fixed ``CHUNK``-slot rows, each row stored as

  ``(anchor int32, deltas int8|int16[CHUNK], escape corrections)``

where ``deltas[:, 0] == 0`` (the anchor position), so decode is a row
cumsum with no dependence between chunks.

Escape lane: a delta that overflows the lane (|delta| > 127 for int8,
> 32767 for int16) is stored as 0 and carried in a per-chunk table of
``k`` slots: ``ovf_pos[r, j]`` is the column of the j-th escape in chunk
``r`` (ascending; ``CHUNK`` marks an unused slot) and ``ovf_add[r, j]``
its full int32 delta.  A chunk with more than ``k`` escapes sets the
sticky ``spill`` flag: the stream no longer round-trips, and checked
builds raise (``flat_graph.compress_host``).

Adaptive widths (DESIGN.md §12): one int8 lane (``deltas``) plus a
per-chunk tag ``wide``.  A narrow chunk stores its delta in the lane; a
wide chunk stores the delta's low byte there and its high byte in a
compacted plane ``hi`` (int8[H, CHUNK]) holding only the wide chunks'
rows, in chunk order, at row ``cumsum(wide) - 1``.  Decode is the
branch-free select ``wide ? hi * 256 + (lane & 0xFF) : lane``.  A chunk
goes wide iff more than ``k`` of its deltas overflow int8; more wide
chunks than ``H`` fold into ``spill``.

Every leaf is bit-identical to the reference's encoders.  Where eager
PyTorch differs from the reference's jit: the lane's low byte is
sign-folded in int32 before the narrowing cast (never relying on how an
out-of-range integer narrows), the escape table comes from a stable
sort, and the hi-plane scatter routes dropped rows to a sink row that is
sliced off (torch has no ``mode="drop"``).  The encoders and decoders
take one unbatched stream (the sharded layout is not ported).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import resolve
from ..kernels import delta_decode

CHUNK = 128  # slots per chunk
OVF_SLOTS = 8  # default static escape-lane capacity per chunk

_WIDTH_DTYPE = {1: torch.int8, 2: torch.int16}
_WIDTH_LIMIT = {1: 127, 2: 32767}


class ChunkedStream(NamedTuple):
    """Delta-encoded int32 stream in fixed ``CHUNK``-slot rows.

    anchors : int32[R]        absolute value at each chunk start
    deltas  : int8|int16[R, CHUNK]  col 0 == 0; escaped deltas hold 0
    ovf_pos : int32[R, K]     column of each escaped delta (pad CHUNK)
    ovf_add : int32[R, K]     the escaped delta's full value
    spill   : bool 0-dim      some chunk had > K escapes (decode unsound)
    hi      : int8[H, CHUNK]  adaptive only: compacted high-byte plane
    wide    : bool[R]         adaptive only: per-chunk width tag

    The encoded length is ``R * CHUNK``; shorter streams are tail-padded
    by repeating the last element (delta 0).
    """

    anchors: torch.Tensor
    deltas: torch.Tensor
    ovf_pos: torch.Tensor
    ovf_add: torch.Tensor
    spill: torch.Tensor
    hi: Optional[torch.Tensor] = None
    wide: Optional[torch.Tensor] = None

    @property
    def length(self) -> int:
        return self.deltas.shape[-2] * self.deltas.shape[-1]

    @property
    def width(self) -> int:
        return self.deltas.element_size()

    @property
    def k(self) -> int:
        return self.ovf_pos.shape[-1]

    @property
    def adaptive(self) -> bool:
        return self.hi is not None

    @property
    def hi_cap(self) -> int:
        """Hi-plane capacity in chunks (0 on fixed-width streams)."""
        return 0 if self.hi is None else self.hi.shape[-2]


def from_state(anchors, deltas, ovf_pos, ovf_add, spill, hi=None, wide=None,
               device=None) -> ChunkedStream:
    """The port's stream from the reference's leaves as numpy arrays, in
    ``ChunkedStream`` field order (``[np.asarray(x) for x in stream]``,
    None kept as None)."""
    dev = resolve(device)

    def t(x):
        return None if x is None else torch.from_numpy(np.array(x)).to(dev)

    return ChunkedStream(t(anchors), t(deltas), t(ovf_pos), t(ovf_add),
                         t(np.asarray(spill, dtype=bool)), t(hi), t(wide))


def _chunk_deltas(values: torch.Tensor):
    """Edge-padded (R, CHUNK) rows and their within-chunk deltas (col 0
    == 0)."""
    v = values.reshape(-1).to(torch.int32)
    if v.numel() == 0:
        v = torch.zeros(1, dtype=torch.int32, device=values.device)
    pad = (-v.numel()) % CHUNK
    if pad:
        v = torch.cat([v, v[-1:].expand(pad)])
    rows = v.reshape(-1, CHUNK)
    prev = torch.cat([rows[:, :1], rows[:, :-1]], dim=1)
    return rows, rows - prev


def _escape_table(esc: torch.Tensor, deltas: torch.Tensor, k: int):
    """(ovf_pos, ovf_add): the first ``k`` escaped columns of each row,
    ascending, padded with (CHUNK, 0) — the reference's
    ``argsort(pos_all)[:, :k]`` as a stable sort."""
    cols = torch.arange(CHUNK, dtype=torch.int32, device=esc.device).expand_as(esc)
    pos_all = torch.where(esc, cols, CHUNK)
    order = torch.sort(pos_all, dim=1, stable=True).indices[:, :k]
    ovf_pos = torch.gather(pos_all, 1, order)
    ovf_add = torch.gather(torch.where(esc, deltas, 0), 1, order)
    return ovf_pos.to(torch.int32), ovf_add.to(torch.int32)


def encode_stream(values: torch.Tensor, width: int = 2, k: int = OVF_SLOTS) -> ChunkedStream:
    """int32[L] -> fixed-width ChunkedStream (``width`` in bytes, escape
    capacity ``k``)."""
    if width not in _WIDTH_DTYPE:
        raise ValueError(f"width must be 1 or 2 bytes, got {width}")
    rows, deltas = _chunk_deltas(values)
    lim = _WIDTH_LIMIT[width]
    esc = (deltas < -lim) | (deltas > lim)
    stored = torch.where(esc, 0, deltas).to(_WIDTH_DTYPE[width])
    ovf_pos, ovf_add = _escape_table(esc, deltas, k)
    return ChunkedStream(
        anchors=rows[:, 0].contiguous(),
        deltas=stored,
        ovf_pos=ovf_pos,
        ovf_add=ovf_add,
        spill=(esc.sum(dim=1) > k).any(),
    )


def encode_stream_adaptive(values: torch.Tensor, hi_cap: int, k: int = OVF_SLOTS) -> ChunkedStream:
    """int32[L] -> adaptive ChunkedStream with a hi plane of ``hi_cap``
    chunk rows.  A chunk goes wide iff more than ``k`` of its deltas
    overflow int8 (narrow escapes are free); running out of hi rows folds
    into ``spill`` like escape overflow."""
    rows, deltas = _chunk_deltas(values)
    abs_d = deltas.abs()
    wide = (abs_d > _WIDTH_LIMIT[1]).sum(dim=1) > k  # bool[R]
    lim = torch.where(wide[:, None], _WIDTH_LIMIT[2], _WIDTH_LIMIT[1])
    esc = abs_d > lim
    stored = torch.where(esc, 0, deltas)  # int32, |.| <= the chunk's limit
    # lane = the signed low byte, folded in int32 before the narrowing cast
    lane = (((stored & 0xFF) ^ 0x80) - 0x80).to(torch.int8)
    ovf_pos, ovf_add = _escape_table(esc, deltas, k)
    wide_i = wide.to(torch.int32)
    hi_idx = torch.cumsum(wide_i, 0) - 1  # compacted row per wide chunk
    # rows that do not fit (wide past hi_cap) drop into the sink row too
    target = torch.where(wide & (hi_idx < hi_cap), hi_idx, hi_cap)
    hi = torch.zeros((hi_cap + 1, CHUNK), dtype=torch.int8, device=rows.device)
    hi[target] = torch.where(wide[:, None], stored >> 8, 0).to(torch.int8)  # arithmetic shift
    spill = (esc.sum(dim=1) > k).any() | (wide_i.sum() > hi_cap)
    return ChunkedStream(
        anchors=rows[:, 0].contiguous(),
        deltas=lane,
        ovf_pos=ovf_pos,
        ovf_add=ovf_add,
        spill=spill,
        hi=hi[:hi_cap],
        wide=wide,
    )


def adaptive_deltas(c: ChunkedStream) -> torch.Tensor:
    """Per-slot int32 deltas of an adaptive stream's lane (escapes still
    0): the width select ``wide ? hi * 256 + (lane & 0xFF) : lane``."""
    return delta_decode.adaptive_deltas(c.deltas, c.hi, c.wide)


def decode_rows(c: ChunkedStream) -> torch.Tensor:
    """Decode to (R, CHUNK) int32 rows: anchor + row cumsum, with each
    escape's delta added at its column.  A stream on the card goes
    through the decode kernel of its layout (``kernels/delta_decode``),
    one on the CPU through its plain version."""
    if c.hi is not None:
        return delta_decode.delta_decode_chunked_adaptive(
            c.anchors, c.deltas, c.hi, c.wide, c.ovf_pos, c.ovf_add)
    return delta_decode.delta_decode_chunked(c.anchors, c.deltas, c.ovf_pos, c.ovf_add)


def decode_stream(c: ChunkedStream, length: int | None = None) -> torch.Tensor:
    """Decode to a flat int32 array (first ``length`` slots; the whole
    padded stream when None)."""
    flat = decode_rows(c).reshape(-1)
    return flat if length is None else flat[:length]


def _tensor_nbytes(t) -> int:
    return t.numel() * t.element_size() if torch.is_tensor(t) else 0


def stream_nbytes(c: ChunkedStream) -> int:
    """Device-resident bytes of the stream (host accounting)."""
    arrays = [c.anchors, c.deltas, c.ovf_pos, c.ovf_add]
    if c.hi is not None:
        arrays += [c.hi, c.wide]
    return sum(_tensor_nbytes(a) for a in arrays)


def pytree_nbytes(tree) -> int:
    """Total bytes of every tensor leaf of nested tuples / NamedTuples /
    lists / dicts (None leaves count nothing, as in a jax pytree)."""
    if torch.is_tensor(tree):
        return _tensor_nbytes(tree)
    if isinstance(tree, dict):
        return sum(pytree_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(pytree_nbytes(v) for v in tree)
    return 0
