"""Paper-faithful C-tree (paper §3–§4, Algorithms 1–3).

A C-tree over a set of integers is ``(tree, prefix)`` where ``tree`` is a
purely-functional search tree (canonical treap, ``pam.py``) keyed by the
*heads* — elements with ``h(e) mod b == 0`` — whose values are their
*tails* (vbyte-compressed chunks of the following non-head elements), and
``prefix`` is the chunk of elements before the first head.

Invariants (checked by ``check_invariants``):
  I1  every key in ``tree`` satisfies the head predicate;
  I2  chunks contain only non-head elements;
  I3  prefix elements < smallest head; tail(h) elements lie strictly
      between h and the next head;
  I4  chunks are sorted and duplicate-free.

Headness is a pure function of the element (hash), so an element is a head
in *any* C-tree containing it — the property that makes Union (Alg. 1)
work by splitting and joining whole chunks rather than re-chunking.

The tree is augmented with element counts so ``size`` is O(1).

Port copy of ``repro/core/ctree.py`` (numpy only), unchanged apart from this note.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np

from .chunks import (
    Chunk,
    chunk_values,
    concat_chunks,
    split_chunk,
    union_chunks,
)
from .hash import is_head_np
from .pam import KEY, LEFT, RIGHT, VAL, Node, TreeModule

DEFAULT_B = 256
DEFAULT_SEED = 0x9E3779B9

# Head-tree module: aug = number of elements (head itself + its tail).
_MOD = TreeModule(
    aug_of=lambda k, tail: 1 + (tail.count if tail is not None else 0),
    combine=lambda a, b: a + b,
    zero=0,
)


class CTree(NamedTuple):
    """A compressed purely-functional ordered integer set."""

    tree: Node  # treap: head (int) -> tail (Chunk | None)
    prefix: Optional[Chunk]
    b: int = DEFAULT_B
    seed: int = DEFAULT_SEED

    # NamedTuple keeps this immutable: every operation returns a new CTree
    # sharing structure with its inputs — snapshots are O(1) (paper §1).


def empty(b: int = DEFAULT_B, seed: int = DEFAULT_SEED) -> CTree:
    return CTree(None, None, b, seed)


def is_empty(c: CTree) -> bool:
    return c.tree is None and c.prefix is None


def ctree_size(c: CTree) -> int:
    """O(1) via augmentation."""
    n = _MOD.aug(c.tree)
    if c.prefix is not None:
        n += c.prefix.count
    return n


# ---------------------------------------------------------------------------
# Build (paper §4.2 / Appendix 10.3)
# ---------------------------------------------------------------------------


def build(values, b: int = DEFAULT_B, seed: int = DEFAULT_SEED) -> CTree:
    """Build(S): sort, dedup, select heads by hash, chunk the rest."""
    values = np.unique(np.asarray(values, dtype=np.int64))
    if values.size == 0:
        return empty(b, seed)
    head_mask = is_head_np(values, b, np.uint32(seed))
    head_idx = np.flatnonzero(head_mask)
    if head_idx.size == 0:
        return CTree(None, Chunk.from_values(values), b, seed)
    prefix = Chunk.from_values(values[: head_idx[0]])
    bounds = np.append(head_idx, values.size)
    entries = []
    for j in range(head_idx.size):
        h = int(values[bounds[j]])
        tail = Chunk.from_values(values[bounds[j] + 1 : bounds[j + 1]])
        entries.append((h, tail))
    return CTree(_MOD.build_sorted(entries), prefix, b, seed)


def to_array(c: CTree) -> np.ndarray:
    """Decode the full ordered set (Map with identity)."""
    parts = []
    if c.prefix is not None:
        parts.append(c.prefix.values())
    for h, tail in _MOD.iter_entries(c.tree):
        parts.append(np.asarray([h], dtype=np.int64))
        if tail is not None:
            parts.append(tail.values())
    if not parts:
        return np.empty(0, dtype=np.int64)
    return np.concatenate(parts)


def map_elements(c: CTree, f) -> None:
    """Map(T, f): apply f to every element in order (paper §4)."""
    if c.prefix is not None:
        for v in c.prefix.values().tolist():
            f(v)
    for h, tail in _MOD.iter_entries(c.tree):
        f(h)
        if tail is not None:
            for v in tail.values().tolist():
                f(v)


# ---------------------------------------------------------------------------
# Find (paper §4.2)
# ---------------------------------------------------------------------------


def find(c: CTree, e: int) -> bool:
    """Membership: search heads for largest head <= e, then scan its tail."""
    if c.prefix is not None and c.prefix.first <= e <= c.prefix.last:
        v = c.prefix.values()
        i = int(np.searchsorted(v, e))
        return i < v.size and v[i] == e
    le = _MOD.find_le(c.tree, e)
    if le is None:
        return False
    h, tail = le
    if h == e:
        return True
    if tail is None or not (tail.first <= e <= tail.last):
        return False
    v = tail.values()
    i = int(np.searchsorted(v, e))
    return i < v.size and v[i] == e


# ---------------------------------------------------------------------------
# Split (paper Algorithm 3)
# ---------------------------------------------------------------------------


def _smallest_head(t: Node) -> Optional[int]:
    f = _MOD.first(t)
    return None if f is None else f[0]


def _split_tree(t: Node, k: int) -> Tuple[Node, bool, Node, Optional[Chunk]]:
    """Split a head-tree (no prefix) by k.

    Returns (left_tree, found, right_tree, right_prefix): ``right_prefix``
    is the chunk of non-heads between k and the right part's smallest head
    (k always lands either *on* a head — whose whole tail moves right — or
    *inside* one chunk, which splits locally; nothing ever dangles left).
    """
    if t is None:
        return None, False, None, None
    L, h, v, R = _MOD.expose(t)
    if k == h:
        # split exactly at a head; h's tail (all > h = k) moves right
        return L, True, R, v
    if k < h:
        lt, found, rt, rpre = _split_tree(L, k)
        return lt, found, _MOD.join(rt, h, v, R), rpre
    # k > h: does k fall inside h's tail?
    if v is not None and k <= v.last:
        v_l, found, v_r = split_chunk(v, k)
        return _MOD.join(L, h, v_l, None), found, R, v_r
    rt_l, found, rt_r, rpre = _split_tree(R, k)
    return _MOD.join(L, h, v, rt_l), found, rt_r, rpre


def split(c: CTree, k: int) -> Tuple[CTree, bool, CTree]:
    """Split(C, k) -> (elements < k, k in C, elements > k)  [Algorithm 3]."""
    b, seed = c.b, c.seed
    # Case: k interacts with the prefix
    if c.prefix is not None:
        if k <= c.prefix.last:
            p_l, found, p_r = split_chunk(c.prefix, k)
            return (
                CTree(None, p_l, b, seed),
                found,
                CTree(c.tree, p_r, b, seed),
            )
    lt, found, rt, rpre = _split_tree(c.tree, k)
    return CTree(lt, c.prefix, b, seed), found, CTree(rt, rpre, b, seed)


def _attach_trailing(c: CTree, chunk: Optional[Chunk]) -> CTree:
    """Append a chunk of non-heads (all larger than every element of c)."""
    if chunk is None:
        return c
    if c.tree is None:
        return CTree(None, concat_chunks(c.prefix, chunk), c.b, c.seed)
    t2, h, v = _MOD.split_last(c.tree)
    return CTree(_MOD.join(t2, h, concat_chunks(v, chunk), None), c.prefix, c.b, c.seed)


# ---------------------------------------------------------------------------
# Union (paper Algorithms 1 & 2)
# ---------------------------------------------------------------------------


def _split_chunk_at(chunk: Optional[Chunk], bound: Optional[int]) -> Tuple[Optional[Chunk], Optional[Chunk]]:
    """SplitChunk(chunk, bound): (< bound, > bound); bound=None => all left.
    ``bound`` is always a head, so it never occurs inside the chunk (I2)."""
    if chunk is None:
        return None, None
    if bound is None:
        return chunk, None
    l, found, r = split_chunk(chunk, bound)
    assert not found, "head found inside a chunk (invariant I2 violated)"
    return l, r


def union(c1: CTree, c2: CTree) -> CTree:
    """UNION (Algorithm 1)."""
    assert c1.b == c2.b and c1.seed == c2.seed
    b, seed = c1.b, c1.seed
    if c1.tree is None:
        return _union_bc(c1, c2)
    if c2.tree is None:
        return _union_bc(c2, c1)
    # expose C2's root
    L2, k2, v2, R2 = _MOD.expose(c2.tree)
    # split C1 by k2; B1 < k2 < B2=(BT2, BP2)
    B1, _found, B2 = split(c1, k2)
    BT2, BP2 = B2.tree, B2.prefix
    # elements of v2 (k2's tail) that belong past B2's first head
    v_l, v_r = _split_chunk_at(v2, _smallest_head(BT2))
    # elements of B2's prefix that belong past R2's first head
    p_l, p_r = _split_chunk_at(BP2, _smallest_head(R2))
    v2p = union_chunks(v_l, p_l)  # k2's new tail
    c_l = union(B1, CTree(L2, c2.prefix, b, seed))
    c_r = union(CTree(BT2, p_r, b, seed), CTree(R2, v_r, b, seed))
    assert c_r.prefix is None, "right union result must have empty prefix"
    return CTree(_MOD.join(c_l.tree, k2, v2p, c_r.tree), c_l.prefix, b, seed)


def _union_bc(c_bc: CTree, c: CTree) -> CTree:
    """UNIONBC (Algorithm 2): union a prefix-only C-tree into ``c``."""
    b, seed = c.b, c.seed
    P1 = c_bc.prefix
    if P1 is None:
        return c
    if c.tree is None:
        return CTree(None, union_chunks(P1, c.prefix), b, seed)
    # split P1 by the smallest head of c's tree
    p_l, p_r = _split_chunk_at(P1, _smallest_head(c.tree))
    new_prefix = union_chunks(p_l, c.prefix)
    tree = c.tree
    if p_r is not None:
        # each element of p_r joins the tail of its preceding head
        vals = p_r.values()
        # FindHead for each element, group ranges by unique head
        heads = np.empty(vals.size, dtype=np.int64)
        for i, e in enumerate(vals.tolist()):
            h, _ = _MOD.find_le(tree, e)
            heads[i] = h
        updates = []
        uniq, starts = np.unique(heads, return_index=True)
        bounds = np.append(starts, vals.size)
        for j, h in enumerate(uniq.tolist()):
            seg = vals[bounds[j] : bounds[j + 1]]
            old_tail = _MOD.find(tree, h)
            updates.append((h, union_chunks(old_tail, Chunk.from_values(seg))))
        tree = _MOD.multi_insert(tree, updates, combine_values=lambda old, new: new)
    return CTree(tree, new_prefix, b, seed)


# ---------------------------------------------------------------------------
# Difference / Intersection (paper §4.1: "conceptually very similar")
# ---------------------------------------------------------------------------


def _join2_ct(cl: CTree, cr: CTree) -> CTree:
    """Join two C-trees where all of cl < all of cr (no middle head).
    cr's prefix re-attaches to cl's largest head's tail."""
    b, seed = cl.b, cl.seed
    cl = _attach_trailing(cl, cr.prefix)
    return CTree(_MOD.join2(cl.tree, cr.tree), cl.prefix, b, seed)


def difference(c1: CTree, c2: CTree) -> CTree:
    """Elements of c1 not in c2 (drives MultiDelete)."""
    assert c1.b == c2.b and c1.seed == c2.seed
    b, seed = c1.b, c1.seed
    if is_empty(c1) or is_empty(c2):
        return c1
    if c2.tree is None:  # deletions are a single chunk
        return _delete_array(c1, c2.prefix.values())
    if c1.tree is None:  # data is a single chunk: filter by membership
        vals = c1.prefix.values()
        keep = np.fromiter((not find(c2, int(e)) for e in vals), bool, vals.size)
        return CTree(None, Chunk.from_values(vals[keep]), b, seed)
    L2, k2, v2, R2 = _MOD.expose(c2.tree)
    B1, _found, B2 = split(c1, k2)  # k2 dropped if present
    c_l = difference(B1, CTree(L2, c2.prefix, b, seed))
    c_r = difference(B2, CTree(R2, v2, b, seed))
    return _join2_ct(c_l, c_r)


def _delete_array(c: CTree, remove: np.ndarray) -> CTree:
    """Delete a sorted array of elements spanning c's range (small batch)."""
    b, seed = c.b, c.seed
    if remove.size == 0 or is_empty(c):
        return c
    out = c
    # split around each removed element's position: since |remove| is the
    # size of one chunk (O(b log n) w.h.p.), do it with split/join passes
    lo, found, rest = split(out, int(remove[0]))
    acc = lo
    for e in remove[1:].tolist():
        seg, found, rest = split(rest, int(e))
        acc = _join2_ct(acc, seg)
    return _join2_ct(acc, rest)


def intersect(c1: CTree, c2: CTree) -> CTree:
    """Elements present in both."""
    assert c1.b == c2.b and c1.seed == c2.seed
    b, seed = c1.b, c1.seed
    if is_empty(c1) or is_empty(c2):
        return empty(b, seed)
    if c2.tree is None:
        vals = c2.prefix.values()
        common = vals[np.fromiter((find(c1, int(e)) for e in vals), bool, vals.size)]
        return CTree(None, Chunk.from_values(common), b, seed)
    if c1.tree is None:
        return intersect(c2, c1)
    L2, k2, v2, R2 = _MOD.expose(c2.tree)
    B1, found, B2 = split(c1, k2)
    c_l = intersect(B1, CTree(L2, c2.prefix, b, seed))
    c_r = intersect(B2, CTree(R2, v2, b, seed))
    if found:
        # k2 is in both: it is a head of the result; the common non-heads
        # below the next surviving head (c_r.prefix) form its tail.
        return CTree(
            _MOD.join(c_l.tree, k2, c_r.prefix, c_r.tree), c_l.prefix, b, seed
        )
    return _join2_ct(c_l, c_r)


# ---------------------------------------------------------------------------
# Batch updates (paper §4.1)
# ---------------------------------------------------------------------------


def multi_insert(c: CTree, values) -> CTree:
    """MultiInsert = Union with a C-tree built over the batch."""
    return union(c, build(values, c.b, c.seed))


def multi_delete(c: CTree, values) -> CTree:
    """MultiDelete = Difference with a C-tree built over the batch."""
    return difference(c, build(values, c.b, c.seed))


def insert_one(c: CTree, e: int) -> CTree:
    return multi_insert(c, [e])


def delete_one(c: CTree, e: int) -> CTree:
    return multi_delete(c, [e])


# ---------------------------------------------------------------------------
# Memory accounting (paper §7.1 byte model) & invariants
# ---------------------------------------------------------------------------

# Paper sizes: uncompressed edge-tree node 32B; C-tree edge node 48B
# (key + tail pointer + children + size/aug) — §7.1.
UNCOMPRESSED_NODE_BYTES = 32
CTREE_NODE_BYTES = 48
CHUNK_HEADER_BYTES = 24  # count + cached first/last (Appendix 10.3)


def nbytes(c: CTree, compressed: bool = True) -> int:
    """Bytes used by this C-tree under the paper's memory model.

    compressed=True: vbyte chunk bytes; False: 8B per chunk element
    ("Aspen (No DE)" column of Table 2).
    """
    total = 0

    def chunk_bytes(ch: Optional[Chunk]) -> int:
        if ch is None:
            return 0
        payload = ch.nbytes if compressed else 8 * ch.count
        return CHUNK_HEADER_BYTES + payload

    total += chunk_bytes(c.prefix)

    def rec(t: Node) -> int:
        if t is None:
            return 0
        return (
            CTREE_NODE_BYTES
            + chunk_bytes(t[VAL])
            + rec(t[LEFT])
            + rec(t[RIGHT])
        )

    return total + rec(c.tree)


def uncompressed_tree_bytes(c: CTree) -> int:
    """Memory if the same set were a plain purely-functional tree."""
    return ctree_size(c) * UNCOMPRESSED_NODE_BYTES


def check_invariants(c: CTree) -> bool:
    """Validate I1-I4 plus the underlying treap invariants."""
    if not _MOD.check_invariants(c.tree):
        return False
    entries = list(_MOD.iter_entries(c.tree))
    heads = [h for h, _ in entries]
    # I1: keys are heads
    if not all(bool(is_head_np(np.int64(h), c.b, np.uint32(c.seed))) for h in heads):
        return False
    lo = -1
    if c.prefix is not None:
        pv = c.prefix.values()
        if (np.diff(pv) <= 0).any():
            return False
        if is_head_np(pv, c.b, np.uint32(c.seed)).any():  # I2
            return False
        if heads and pv[-1] >= heads[0]:  # I3
            return False
        if c.prefix.first != pv[0] or c.prefix.last != pv[-1]:
            return False
    for i, (h, tail) in enumerate(entries):
        nxt = heads[i + 1] if i + 1 < len(heads) else None
        if tail is not None:
            tv = tail.values()
            if (np.diff(tv) <= 0).any():
                return False
            if is_head_np(tv, c.b, np.uint32(c.seed)).any():  # I2
                return False
            if tv[0] <= h:
                return False
            if nxt is not None and tv[-1] >= nxt:  # I3
                return False
            if tail.first != tv[0] or tail.last != tv[-1]:
                return False
    return True
