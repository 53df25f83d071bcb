"""Purely-functional augmented search tree (the PAM [73] analogue).

The paper stores C-tree heads — and Aspen's vertex-tree — in a
purely-functional balanced search tree with join-based bulk operations
(Blelloch et al., "Just Join for Parallel Ordered Sets" [13]).  We use a
*treap with deterministic hash priorities*: the paper's w.h.p. bounds hold
for treaps, join/split/union are the textbook join-based algorithms, and —
crucially for testing — hash priorities make the tree **canonical**
(history-independent): any sequence of operations producing the same
key-set produces the *identical* structure.  Property tests exploit this.

Nodes are immutable 6-tuples ``(key, value, left, right, size, aug)``;
every update path-copies O(log n) nodes, so a snapshot is a root pointer —
exactly the property Aspen builds on (paper §1, §6).

Augmentation: a ``TreeModule`` carries ``aug_of(key, value) -> A`` and an
associative ``combine(A, A) -> A`` with identity ``zero``; each node caches
the aug-sum of its subtree, giving O(1) "total edges in graph" queries
(paper §5: "We augment the vertex-tree to store the number of edges").

Port copy of ``repro/core/pam.py`` (numpy only), unchanged apart from this note.
"""
from __future__ import annotations

import sys
from typing import Any, Callable, Iterator, List, Optional, Tuple

sys.setrecursionlimit(1_000_000)

# Node = (key, value, left, right, size, aug).  None is the empty tree.
Node = Optional[Tuple]

KEY, VAL, LEFT, RIGHT, SIZE, AUG = range(6)

_M32 = 0xFFFFFFFF


def _pri(key: int) -> int:
    """Deterministic treap priority (murmur3 fmix32, pure-Python for speed);
    ties broken by key so the tree shape is canonical."""
    h = (key ^ 0xDEADBEEF) & _M32
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _M32
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _M32
    h ^= h >> 16
    return (h << 32) | (key & _M32)


def size(t: Node) -> int:
    return 0 if t is None else t[SIZE]


class TreeModule:
    """Factory for purely-functional treaps sharing one augmentation monoid."""

    def __init__(
        self,
        aug_of: Callable[[Any, Any], Any] = lambda k, v: 0,
        combine: Callable[[Any, Any], Any] = lambda a, b: a + b,
        zero: Any = 0,
    ):
        self.aug_of = aug_of
        self.combine = combine
        self.zero = zero

    # -- node construction ------------------------------------------------
    def node(self, key, value, left: Node, right: Node) -> Node:
        aug = self.aug_of(key, value)
        if left is not None:
            aug = self.combine(left[AUG], aug)
        if right is not None:
            aug = self.combine(aug, right[AUG])
        return (key, value, left, right, 1 + size(left) + size(right), aug)

    def aug(self, t: Node):
        return self.zero if t is None else t[AUG]

    # -- core join-based primitives ---------------------------------------
    def join(self, left: Node, key, value, right: Node) -> Node:
        """Treap join: assumes max(left) < key < min(right)."""
        pk = _pri(key)
        pl = _pri(left[KEY]) if left is not None else -1
        pr = _pri(right[KEY]) if right is not None else -1
        if pk >= pl and pk >= pr:
            return self.node(key, value, left, right)
        if pl >= pr:  # left root wins
            return self.node(
                left[KEY], left[VAL], left[LEFT], self.join(left[RIGHT], key, value, right)
            )
        return self.node(
            right[KEY], right[VAL], self.join(left, key, value, right[LEFT]), right[RIGHT]
        )

    def join2(self, left: Node, right: Node) -> Node:
        """Join without a middle key."""
        if left is None:
            return right
        if right is None:
            return left
        l2, k, v = self.split_last(left)
        return self.join(l2, k, v, right)

    def split_last(self, t: Node) -> Tuple[Node, Any, Any]:
        """Remove and return the largest entry."""
        if t[RIGHT] is None:
            return t[LEFT], t[KEY], t[VAL]
        r2, k, v = self.split_last(t[RIGHT])
        return self.node(t[KEY], t[VAL], t[LEFT], r2), k, v

    def split_first(self, t: Node) -> Tuple[Any, Any, Node]:
        if t[LEFT] is None:
            return t[KEY], t[VAL], t[RIGHT]
        k, v, l2 = self.split_first(t[LEFT])
        return k, v, self.node(t[KEY], t[VAL], l2, t[RIGHT])

    def expose(self, t: Node) -> Tuple[Node, Any, Any, Node]:
        """(left, key, value, right) of the root (paper §4.1 Expose)."""
        return t[LEFT], t[KEY], t[VAL], t[RIGHT]

    def split(self, t: Node, key) -> Tuple[Node, Optional[Any], Node]:
        """(tree < key, value if key present else None, tree > key)."""
        if t is None:
            return None, None, None
        if key < t[KEY]:
            ll, m, lr = self.split(t[LEFT], key)
            return ll, m, self.join(lr, t[KEY], t[VAL], t[RIGHT])
        if key > t[KEY]:
            rl, m, rr = self.split(t[RIGHT], key)
            return self.join(t[LEFT], t[KEY], t[VAL], rl), m, rr
        return t[LEFT], t[VAL] if t[VAL] is not None else True, t[RIGHT]

    # -- queries -----------------------------------------------------------
    def find(self, t: Node, key):
        while t is not None:
            if key < t[KEY]:
                t = t[LEFT]
            elif key > t[KEY]:
                t = t[RIGHT]
            else:
                return t[VAL]
        return None

    def find_le(self, t: Node, key):
        """Entry with the largest key' <= key (paper Find semantics)."""
        best = None
        while t is not None:
            if t[KEY] == key:
                return (t[KEY], t[VAL])
            if t[KEY] < key:
                best = (t[KEY], t[VAL])
                t = t[RIGHT]
            else:
                t = t[LEFT]
        return best

    def first(self, t: Node):
        if t is None:
            return None
        while t[LEFT] is not None:
            t = t[LEFT]
        return (t[KEY], t[VAL])

    def last(self, t: Node):
        if t is None:
            return None
        while t[RIGHT] is not None:
            t = t[RIGHT]
        return (t[KEY], t[VAL])

    def rank(self, t: Node, key) -> int:
        """# keys < key."""
        r = 0
        while t is not None:
            if key <= t[KEY]:
                t = t[LEFT]
            else:
                r += 1 + size(t[LEFT])
                t = t[RIGHT]
        return r

    def select(self, t: Node, i: int):
        """i-th (0-based) entry in key order."""
        while t is not None:
            sl = size(t[LEFT])
            if i < sl:
                t = t[LEFT]
            elif i == sl:
                return (t[KEY], t[VAL])
            else:
                i -= sl + 1
                t = t[RIGHT]
        raise IndexError(i)

    # -- traversal ---------------------------------------------------------
    def iter_entries(self, t: Node) -> Iterator[Tuple[Any, Any]]:
        """In-order iterator (iterative; no recursion-depth limits)."""
        stack: List = []
        while stack or t is not None:
            while t is not None:
                stack.append(t)
                t = t[LEFT]
            t = stack.pop()
            yield (t[KEY], t[VAL])
            t = t[RIGHT]

    def keys(self, t: Node) -> list:
        return [k for k, _ in self.iter_entries(t)]

    def map_values(self, t: Node, f: Callable[[Any, Any], Any]) -> Node:
        """Rebuild with value' = f(key, value) (structure preserved)."""
        if t is None:
            return None
        return self.node(
            t[KEY], f(t[KEY], t[VAL]), self.map_values(t[LEFT], f), self.map_values(t[RIGHT], f)
        )

    def foreach(self, t: Node, f: Callable[[Any, Any], None]) -> None:
        for k, v in self.iter_entries(t):
            f(k, v)

    # -- bulk construction / set algebra ------------------------------------
    def build_sorted(self, entries: List[Tuple[Any, Any]]) -> Node:
        """Build from strictly-increasing (key, value) pairs in O(n).

        Stack-based max-Cartesian-tree construction on the hash priorities
        produces exactly the canonical treap that repeated joins would."""
        n = len(entries)
        if n == 0:
            return None
        pris = [_pri(k) for k, _ in entries]
        left = [-1] * n
        right = [-1] * n
        stack: List[int] = []
        for i in range(n):
            last = -1
            while stack and pris[stack[-1]] < pris[i]:
                last = stack.pop()
            left[i] = last
            if stack:
                right[stack[-1]] = i
            stack.append(i)
        root = stack[0]
        # freeze bottom-up: iterative post-order so child tuples exist first
        frozen: List[Node] = [None] * n
        todo = [(root, False)]
        while todo:
            i, ready = todo.pop()
            if ready:
                k, v = entries[i]
                frozen[i] = self.node(
                    k,
                    v,
                    frozen[left[i]] if left[i] >= 0 else None,
                    frozen[right[i]] if right[i] >= 0 else None,
                )
            else:
                todo.append((i, True))
                if left[i] >= 0:
                    todo.append((left[i], False))
                if right[i] >= 0:
                    todo.append((right[i], False))
        return frozen[root]

    def insert(self, t: Node, key, value, combine_values=None) -> Node:
        l, m, r = self.split(t, key)
        if m is not None and combine_values is not None:
            value = combine_values(m, value)
        return self.join(l, key, value, r)

    def delete(self, t: Node, key) -> Node:
        l, m, r = self.split(t, key)
        return self.join2(l, r)

    def union(self, a: Node, b: Node, combine_values=None) -> Node:
        """Join-based Union [13]; values combined where keys collide."""
        if a is None:
            return b
        if b is None:
            return a
        bl, bk, bv, br = self.expose(b)
        al, m, ar = self.split(a, bk)
        if m is not None and m is not True and combine_values is not None:
            bv = combine_values(m, bv)
        return self.join(
            self.union(al, bl, combine_values), bk, bv, self.union(ar, br, combine_values)
        )

    def difference(self, a: Node, b: Node) -> Node:
        """Keys of a not present in b."""
        if a is None or b is None:
            return a
        bl, bk, _, br = self.expose(b)
        al, _, ar = self.split(a, bk)
        return self.join2(self.difference(al, bl), self.difference(ar, br))

    def intersect(self, a: Node, b: Node, combine_values=None) -> Node:
        if a is None or b is None:
            return None
        bl, bk, bv, br = self.expose(b)
        al, m, ar = self.split(a, bk)
        il, ir = self.intersect(al, bl, combine_values), self.intersect(ar, br, combine_values)
        if m is not None:
            if m is not True and combine_values is not None:
                bv = combine_values(m, bv)
            return self.join(il, bk, bv, ir)
        return self.join2(il, ir)

    def multi_insert(self, t: Node, entries, combine_values=None) -> Node:
        """MultiInsert(T, f, S): batch insert sorted-or-not entries."""
        entries = sorted(entries, key=lambda e: e[0])
        dedup: List = []
        for k, v in entries:
            if dedup and dedup[-1][0] == k:
                if combine_values is not None:
                    dedup[-1] = (k, combine_values(dedup[-1][1], v))
                else:
                    dedup[-1] = (k, v)
            else:
                dedup.append((k, v))
        return self.union(t, self.build_sorted(dedup), combine_values)

    def multi_delete(self, t: Node, keys) -> Node:
        ks = sorted(set(keys))
        return self.difference(t, self.build_sorted([(k, None) for k in ks]))

    # -- structural metrics (for the paper's memory model) ------------------
    def height(self, t: Node) -> int:
        if t is None:
            return 0
        return 1 + max(self.height(t[LEFT]), self.height(t[RIGHT]))

    def check_invariants(self, t: Node, lo=None, hi=None) -> bool:
        """BST order + heap priority + size/aug consistency (for tests)."""
        if t is None:
            return True
        k = t[KEY]
        if (lo is not None and k <= lo) or (hi is not None and k >= hi):
            return False
        for c in (t[LEFT], t[RIGHT]):
            if c is not None and _pri(c[KEY]) > _pri(k):
                return False
        if t[SIZE] != 1 + size(t[LEFT]) + size(t[RIGHT]):
            return False
        a = self.aug_of(k, t[VAL])
        if t[LEFT] is not None:
            a = self.combine(t[LEFT][AUG], a)
        if t[RIGHT] is not None:
            a = self.combine(a, t[RIGHT][AUG])
        if a != t[AUG]:
            return False
        return self.check_invariants(t[LEFT], lo, k) and self.check_invariants(
            t[RIGHT], k, hi
        )


# A plain set-like module (no augmentation) shared by C-tree internals.
SET_MODULE = TreeModule()
