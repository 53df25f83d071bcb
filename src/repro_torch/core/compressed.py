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
sliced off (torch has no ``mode="drop"``).  ``encode_rows`` /
``encode_rows_adaptive`` / ``decode_rows_batched`` take a batch of
equal-length rows (the sharded pool's ``(S, ...)`` leaves, each row
encoded on its own, as the reference's vmapped encoders do); the decode
flattens the batch into one stream and runs one kernel call.
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
    """Edge-padded (S * R, CHUNK) rows of a batch of S equal-length rows
    (each row padded by repeating its own last element) and their
    within-chunk deltas (col 0 == 0)."""
    v = values.to(torch.int32)
    if v.shape[-1] == 0:
        v = torch.zeros((v.shape[0], 1), dtype=torch.int32, device=values.device)
    pad = (-v.shape[-1]) % CHUNK
    if pad:
        v = torch.cat([v, v[:, -1:].expand(v.shape[0], pad)], dim=1)
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


def encode_rows(values: torch.Tensor, width: int = 2, k: int = OVF_SLOTS) -> ChunkedStream:
    """int32[S, L] -> fixed-width ChunkedStream with (S, ...) leaves and
    one spill flag per row (each row encoded on its own)."""
    if width not in _WIDTH_DTYPE:
        raise ValueError(f"width must be 1 or 2 bytes, got {width}")
    S = values.shape[0]
    rows, deltas = _chunk_deltas(values)
    lim = _WIDTH_LIMIT[width]
    esc = (deltas < -lim) | (deltas > lim)
    stored = torch.where(esc, 0, deltas).to(_WIDTH_DTYPE[width])
    ovf_pos, ovf_add = _escape_table(esc, deltas, k)
    return ChunkedStream(
        anchors=rows[:, 0].reshape(S, -1).contiguous(),
        deltas=stored.reshape(S, -1, CHUNK),
        ovf_pos=ovf_pos.reshape(S, -1, ovf_pos.shape[1]),
        ovf_add=ovf_add.reshape(S, -1, ovf_add.shape[1]),
        spill=(esc.sum(dim=1) > k).reshape(S, -1).any(dim=1),
    )


def encode_rows_adaptive(values: torch.Tensor, hi_cap: int, k: int = OVF_SLOTS) -> ChunkedStream:
    """int32[S, L] -> adaptive ChunkedStream with (S, ...) leaves: each
    row has its own hi plane of ``hi_cap`` chunk rows, compacted in that
    row's chunk order.  A chunk goes wide iff more than ``k`` of its
    deltas overflow int8 (narrow escapes are free); running out of hi
    rows folds into the row's ``spill`` like escape overflow."""
    S = values.shape[0]
    rows, deltas = _chunk_deltas(values)
    abs_d = deltas.abs()
    wide = (abs_d > _WIDTH_LIMIT[1]).sum(dim=1) > k  # bool[S * R]
    lim = torch.where(wide[:, None], _WIDTH_LIMIT[2], _WIDTH_LIMIT[1])
    esc = abs_d > lim
    stored = torch.where(esc, 0, deltas)  # int32, |.| <= the chunk's limit
    # lane = the signed low byte, folded in int32 before the narrowing cast
    lane = (((stored & 0xFF) ^ 0x80) - 0x80).to(torch.int8)
    ovf_pos, ovf_add = _escape_table(esc, deltas, k)
    wide_r = wide.reshape(S, -1)
    wide_i = wide_r.to(torch.int32)
    hi_idx = torch.cumsum(wide_i, 1) - 1  # compacted row per wide chunk, per row
    # rows that do not fit (wide past hi_cap) drop into the sink row too
    target = torch.where(wide_r & (hi_idx < hi_cap), hi_idx, hi_cap)
    hi = torch.zeros((S, hi_cap + 1, CHUNK), dtype=torch.int8, device=rows.device)
    row_of = torch.arange(S, device=rows.device)[:, None].expand_as(target)
    hi[row_of, target] = torch.where(wide[:, None], stored >> 8, 0).to(
        torch.int8).reshape(S, -1, CHUNK)  # arithmetic shift
    spill = (esc.sum(dim=1) > k).reshape(S, -1).any(dim=1) | (wide_i.sum(1) > hi_cap)
    return ChunkedStream(
        anchors=rows[:, 0].reshape(S, -1).contiguous(),
        deltas=lane.reshape(S, -1, CHUNK),
        ovf_pos=ovf_pos.reshape(S, -1, ovf_pos.shape[1]),
        ovf_add=ovf_add.reshape(S, -1, ovf_add.shape[1]),
        spill=spill,
        hi=hi[:, :hi_cap],
        wide=wide_r,
    )


def _row(c: ChunkedStream) -> ChunkedStream:
    """The only row of a one-row batch as an unbatched stream."""
    return ChunkedStream(*(None if x is None else x[0] for x in c))


def encode_stream(values: torch.Tensor, width: int = 2, k: int = OVF_SLOTS) -> ChunkedStream:
    """int32[L] -> fixed-width ChunkedStream (``width`` in bytes, escape
    capacity ``k``)."""
    return _row(encode_rows(values.reshape(1, -1), width=width, k=k))


def encode_stream_adaptive(values: torch.Tensor, hi_cap: int, k: int = OVF_SLOTS) -> ChunkedStream:
    """int32[L] -> adaptive ChunkedStream with a hi plane of ``hi_cap``
    chunk rows (see ``encode_rows_adaptive``)."""
    return _row(encode_rows_adaptive(values.reshape(1, -1), hi_cap=hi_cap, k=k))


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


def flatten_rows(c: ChunkedStream) -> ChunkedStream:
    """A batched stream's (S, ...) leaves as ONE unbatched stream of S * R
    chunk rows, so a single kernel call decodes (or reduces over) every
    row.  Each row's hi plane is compacted into one plane in row order,
    which is where the flat stream's ``cumsum(wide) - 1`` looks (exact
    for streams that did not spill)."""
    S, R = c.anchors.shape
    hi = wide = None
    if c.hi is not None:
        H = c.hi.shape[1]
        wide = c.wide.reshape(-1)
        local = torch.cumsum(c.wide.to(torch.int32), 1) - 1  # row within its own plane
        glob = torch.cumsum(wide.to(torch.int32), 0) - 1  # row within the joined plane
        # a row that spilled its plane decodes unsoundly either way; its
        # excess wide chunks are kept off the joined plane
        keep = wide & (local.reshape(-1) < H) & (glob < S * H)
        src = (torch.arange(S, device=wide.device)[:, None] * H + local.clamp(0, max(H - 1, 0)))
        hi = torch.zeros((S * H + 1, CHUNK), dtype=torch.int8, device=wide.device)
        if H:
            hi[torch.where(keep, glob, S * H).long()] = c.hi.reshape(S * H, CHUNK)[
                src.reshape(-1).long()]
        hi = hi[: S * H]
    return ChunkedStream(
        c.anchors.reshape(-1).contiguous(),
        c.deltas.reshape(S * R, CHUNK),
        c.ovf_pos.reshape(S * R, -1),
        c.ovf_add.reshape(S * R, -1),
        c.spill.any(),
        hi,
        wide,
    )


def row_prefix(c: ChunkedStream, R: int) -> ChunkedStream:
    """The first ``R`` chunk rows of each row of a batched stream (the hi
    planes stay whole: a prefix's wide chunks are its plane's first
    rows)."""
    if R >= c.anchors.shape[1]:
        return c
    return c._replace(anchors=c.anchors[:, :R], deltas=c.deltas[:, :R], ovf_pos=c.ovf_pos[:, :R],
                      ovf_add=c.ovf_add[:, :R], wide=None if c.wide is None else c.wide[:, :R])


def decode_rows_batched(c: ChunkedStream) -> torch.Tensor:
    """Decode a batched stream to (S, R * CHUNK) int32 rows with ONE
    decode-kernel call over the flattened rows (``flatten_rows``)."""
    S = c.anchors.shape[0]
    return decode_rows(flatten_rows(c)).reshape(S, -1)


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
