"""Chunk compression for C-trees (paper §3.2, "Integer C-trees").

Two codecs:

1. ``vbyte_*`` — the paper's byte code: difference-encode the sorted chunk,
   then emit each delta as little-endian 7-bit groups with a continuation
   bit.  Sequential decode; used by the faithful host C-tree
   (core/ctree.py) and by the byte-accurate memory benchmarks (Table 2).

2. ``pack_deltas`` / ``unpack_deltas`` — the TPU adaptation: fixed-width
   deltas (uint8/uint16) with an escape side-table for overflowing deltas.
   Fixed width turns decode into a *vectorizable segmented cumsum* (the
   Pallas kernel in kernels/delta_decode.py) at a small ratio cost vs.
   byte codes, which the paper itself already traded toward decode speed
   (§3.2: "byte-codes ... fast to decode while achieving most of the
   memory savings").

Both codecs store the chunk's first element absolutely (the anchor) and the
first/last values cached at the chunk head so Split/Find can decide in O(1)
whether a key falls inside the chunk (paper §4.1 Split).

Port copy of ``repro/core/chunks.py`` (numpy only), unchanged apart from this note.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

# ---------------------------------------------------------------------------
# Paper-faithful byte code (vbyte over deltas)
# ---------------------------------------------------------------------------


def vbyte_encode_scalar(values: np.ndarray) -> bytes:
    """Reference scalar encoder (property-tested against the vector path)."""
    values = np.asarray(values, dtype=np.int64)
    if values.size == 0:
        return b""
    deltas = np.empty_like(values)
    deltas[0] = values[0]
    deltas[1:] = values[1:] - values[:-1]
    out = bytearray()
    for d in deltas.tolist():
        if d < 0:
            raise ValueError("chunk must be sorted/non-negative for vbyte")
        while True:
            byte = d & 0x7F
            d >>= 7
            if d:
                out.append(byte | 0x80)
            else:
                out.append(byte)
                break
    return bytes(out)


def vbyte_decode_scalar(buf: bytes) -> np.ndarray:
    """Reference scalar decoder."""
    vals = []
    acc = 0
    cur = 0
    shift = 0
    for byte in buf:
        cur |= (byte & 0x7F) << shift
        if byte & 0x80:
            shift += 7
        else:
            acc += cur
            vals.append(acc)
            cur = 0
            shift = 0
    return np.asarray(vals, dtype=np.int64)


def vbyte_encode(values: np.ndarray) -> bytes:
    """Difference + 7-bit varint encode a sorted int array (vectorized).

    <=10 masked vector passes (one per 7-bit group of a 64-bit delta)
    instead of a per-element Python loop; exact same byte stream as
    ``vbyte_encode_scalar``.
    """
    values = np.asarray(values, dtype=np.int64)
    n = values.size
    if n == 0:
        return b""
    deltas = np.empty(n, dtype=np.uint64)
    deltas[0] = values[0]
    if n > 1:
        d = values[1:] - values[:-1]
        if (d < 0).any() or values[0] < 0:
            raise ValueError("chunk must be sorted/non-negative for vbyte")
        deltas[1:] = d.astype(np.uint64)
    # bytes per delta: ceil(bit_length / 7) with min 1
    ngroups = np.ones(n, dtype=np.int64)
    thresh = np.uint64(1 << 7)
    tmp = deltas.copy()
    while True:
        more = tmp >= thresh
        if not more.any():
            break
        ngroups += more
        tmp = tmp >> np.uint64(7)
    offs = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(ngroups, out=offs[1:])
    out = np.zeros(offs[-1], dtype=np.uint8)
    max_g = int(ngroups.max())
    for g in range(max_g):
        sel = ngroups > g
        byte = ((deltas[sel] >> np.uint64(7 * g)) & np.uint64(0x7F)).astype(np.uint8)
        cont = (ngroups[sel] - 1 > g).astype(np.uint8) << 7
        out[offs[:-1][sel] + g] = byte | cont
    return out.tobytes()


def vbyte_decode(buf: bytes) -> np.ndarray:
    """Inverse of vbyte_encode (vectorized segmented shift-accumulate)."""
    if not buf:
        return np.empty(0, dtype=np.int64)
    raw = np.frombuffer(buf, dtype=np.uint8)
    is_last = (raw & 0x80) == 0
    starts = np.flatnonzero(np.concatenate(([True], is_last[:-1])))
    vidx = np.zeros(raw.size, dtype=np.int64)
    vidx[starts[1:]] = 1
    np.cumsum(vidx, out=vidx)
    pos = np.arange(raw.size, dtype=np.int64) - starts[vidx]
    contrib = (raw & 0x7F).astype(np.int64) << (7 * pos)
    deltas = np.add.reduceat(contrib, starts)
    return np.cumsum(deltas)


class Chunk(NamedTuple):
    """A compressed tail/prefix for the faithful C-tree.

    first/last are cached for O(1) range checks (paper Appendix 10.3:
    "store the first and last elements at the head of each chunk").
    """

    buf: bytes
    count: int
    first: int
    last: int

    @staticmethod
    def from_values(values: np.ndarray) -> "Chunk | None":
        values = np.asarray(values, dtype=np.int64)
        if values.size == 0:
            return None
        return Chunk(vbyte_encode(values), int(values.size),
                     int(values[0]), int(values[-1]))

    def values(self) -> np.ndarray:
        return vbyte_decode(self.buf)

    @property
    def nbytes(self) -> int:
        return len(self.buf)


EMPTY = None  # an empty chunk is represented as None throughout ctree.py


def chunk_values(c: "Chunk | None") -> np.ndarray:
    return c.values() if c is not None else np.empty(0, dtype=np.int64)


def split_chunk(c: "Chunk | None", k: int) -> tuple["Chunk | None", bool, "Chunk | None"]:
    """SplitChunk: (values < k, k present?, values > k)."""
    if c is None:
        return None, False, None
    # O(1) fast paths via cached first/last
    if k < c.first:
        return None, False, c
    if k > c.last:
        return c, False, None
    v = c.values()
    i = int(np.searchsorted(v, k, side="left"))
    found = i < v.size and v[i] == k
    left = Chunk.from_values(v[:i])
    right = Chunk.from_values(v[i + (1 if found else 0):])
    return left, bool(found), right


def union_chunks(a: "Chunk | None", b: "Chunk | None") -> "Chunk | None":
    if a is None:
        return b
    if b is None:
        return a
    merged = np.union1d(a.values(), b.values())
    return Chunk.from_values(merged)


def concat_chunks(a: "Chunk | None", b: "Chunk | None") -> "Chunk | None":
    """Concatenate chunks where all of ``a`` < all of ``b`` (no merge)."""
    if a is None:
        return b
    if b is None:
        return a
    assert a.last < b.first, "concat_chunks requires disjoint ordered chunks"
    return Chunk.from_values(np.concatenate([a.values(), b.values()]))


def diff_chunk(a: "Chunk | None", remove: np.ndarray) -> "Chunk | None":
    """Elements of ``a`` not present in sorted array ``remove``."""
    if a is None or remove.size == 0:
        return a
    v = a.values()
    keep = ~np.isin(v, remove, assume_unique=True)
    return Chunk.from_values(v[keep])


def intersect_chunk(a: "Chunk | None", other: np.ndarray) -> "Chunk | None":
    """Elements of ``a`` also present in sorted array ``other``."""
    if a is None or other.size == 0:
        return None
    v = a.values()
    return Chunk.from_values(v[np.isin(v, other, assume_unique=True)])


# ---------------------------------------------------------------------------
# TPU adaptation: fixed-width packed deltas with overflow escape
# ---------------------------------------------------------------------------


class PackedDeltas(NamedTuple):
    """Fixed-width delta pool over a flat sorted array partitioned into
    chunks at ``chunk_off`` boundaries.  Chunk i's first element is stored
    absolutely in ``anchors[i]``; subsequent deltas are ``width``-bit with
    the all-ones pattern escaping to ``overflow``.
    """

    deltas: np.ndarray      # uint8/uint16 [n] (delta of element vs predecessor; anchor pos holds 0)
    anchors: np.ndarray     # int64 [n_chunks] absolute first element per chunk
    chunk_off: np.ndarray   # int64 [n_chunks + 1] offsets into deltas
    overflow: np.ndarray    # int64 [n_overflow] escaped deltas in order
    dtype: str              # "uint8" | "uint16"

    @property
    def nbytes(self) -> int:
        return (self.deltas.nbytes + self.anchors.nbytes
                + self.chunk_off.nbytes + self.overflow.nbytes)


def pack_deltas(data: np.ndarray, chunk_off: np.ndarray, width: str = "uint16") -> PackedDeltas:
    data = np.asarray(data, dtype=np.int64)
    chunk_off = np.asarray(chunk_off, dtype=np.int64)
    n = data.size
    esc = np.iinfo(np.dtype(width)).max
    deltas = np.zeros(n, dtype=np.int64)
    if n:
        deltas[1:] = data[1:] - data[:-1]
    anchors = data[chunk_off[:-1]] if chunk_off.size > 1 else np.empty(0, np.int64)
    if chunk_off.size > 1:
        deltas[chunk_off[:-1]] = 0  # anchor positions carry no delta
    ovf_mask = deltas >= esc
    overflow = deltas[ovf_mask]
    packed = np.where(ovf_mask, esc, deltas).astype(np.dtype(width))
    return PackedDeltas(packed, anchors, chunk_off, overflow, width)


def unpack_deltas(p: PackedDeltas) -> np.ndarray:
    """Reference (numpy) decode: segmented cumsum of deltas from anchors.
    The jit/Pallas equivalents live in kernels/delta_decode.py."""
    esc = np.iinfo(np.dtype(p.dtype)).max
    d = p.deltas.astype(np.int64)
    ovf_mask = d == esc
    d[ovf_mask] = p.overflow
    if p.chunk_off.size > 1:
        d[p.chunk_off[:-1]] = p.anchors
    # segmented cumsum: subtract the running total at each chunk start
    out = np.cumsum(d)
    if p.chunk_off.size > 1:
        starts = p.chunk_off[:-1]
        base = out[starts] - p.anchors
        out -= np.repeat(base, np.diff(p.chunk_off))
    return out
