"""Version maintenance: acquire / set / release (paper §6, [8]).

The paper solves the *version maintenance problem* with a lock-free
algorithm because CPU writers and readers race on the version list.  In
our single-controller runtime the writer is the Python host, so a host
mutex around the (tiny, O(1)) version-list operations preserves the exact
interface and serializability guarantees; lock-freedom addresses a race
that cannot occur here (documented in DESIGN.md §2).

Guarantees preserved from the paper:
  * any number of concurrent readers acquire snapshots without blocking
    the writer or each other (they hold immutable structure);
  * a single writer ACQUIREs, builds functionally, SETs — the new version
    becomes atomically visible to subsequent acquires;
  * RELEASE refcounts; a version is garbage-collected (dropped from the
    live list, letting shared tree nodes be reclaimed) when its refcount
    reaches zero and it is not current — strict serializability holds
    because every query runs against exactly one immutable version.

Dual representations (DESIGN.md §6): a version may carry *auxiliary*
representations of the same logical graph alongside the primary one —
e.g. the C-tree ``Graph`` paired with its device-resident ``FlatGraph``
mirror.  ``set(graph, aux=...)`` publishes them atomically as ONE
version, so readers always observe a consistent (graph, aux) pair and
pick their substrate at acquire time with zero rebuild.  Each version
also owns a ``cache`` dict (version-pinned derived state, e.g. traversal
engines keyed by backend); the cache — and everything in it — dies with
the version when the last reference drops, so engine caches can never
leak across the version lifecycle or outlive their snapshot.

Port copy of ``repro/core/versioning.py`` (numpy only), unchanged apart from
this note and ``live_stamps`` (the stamps a rank-0 service names to its
follower ranks, ``serve/graph/collective.py``).
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Generic, List, Optional, TypeVar

import numpy as np

G = TypeVar("G")

DELTA = "delta"  # aux key of the per-version update record


class Delta:
    """The edge batch one published version applied to its predecessor.

    Versions are purely functional, so the diff between consecutive
    stamps is exactly the batch the writer applied — recording it at
    publish time makes the diff a first-class artifact the incremental
    query path (warm-start PageRank, incremental CC/BFS/SSSP) consumes
    instead of recomputing from scratch.  Stored per version in
    ``Version.aux[DELTA]``, so it is GC'd with its version like every
    other aux representation.

    ``ins``/``dels`` are directed int64[k, 2] edge arrays exactly as
    applied (a symmetric insert records both directions); ``ins_w`` is
    the per-inserted-edge value lane or None.  A version published
    through a non-edge path (vertex-set ops, raw ``vg`` writes) carries
    no delta at all, which ``delta_between`` reports as None — the
    full-recompute signal.
    """

    __slots__ = ("ins", "ins_w", "dels", "__weakref__")

    def __init__(
        self,
        ins: Optional[np.ndarray] = None,
        ins_w: Optional[np.ndarray] = None,
        dels: Optional[np.ndarray] = None,
    ):
        empty = np.empty((0, 2), dtype=np.int64)
        self.ins = empty if ins is None else np.asarray(ins, np.int64).reshape(-1, 2)
        self.dels = empty if dels is None else np.asarray(dels, np.int64).reshape(-1, 2)
        self.ins_w = None if ins_w is None else np.asarray(ins_w, np.float32).reshape(-1)

    @property
    def empty(self) -> bool:
        return self.ins.shape[0] == 0 and self.dels.shape[0] == 0

    @property
    def has_deletions(self) -> bool:
        return self.dels.shape[0] > 0

    @property
    def endpoints(self) -> np.ndarray:
        """Unique vertex ids touched by the batch (the perturbation /
        seed-frontier set of the incremental algorithms)."""
        return np.unique(np.concatenate([self.ins.ravel(), self.dels.ravel()]))

    @property
    def nbytes(self) -> int:
        w = 0 if self.ins_w is None else self.ins_w.nbytes
        return self.ins.nbytes + self.dels.nbytes + w

    @classmethod
    def concat(cls, parts: "List[Delta]") -> "Delta":
        """Compose deltas across consecutive stamps.  Inserts and
        deletes are unioned independently — conservative for the
        incremental consumers (they relax over the NEW snapshot, so
        seeds/dirty sets may only be supersets)."""
        if not parts:
            return cls()
        ins = np.concatenate([p.ins for p in parts])
        dels = np.concatenate([p.dels for p in parts])
        if any(p.ins_w is not None for p in parts):
            ins_w = np.concatenate(
                [
                    p.ins_w
                    if p.ins_w is not None
                    else np.ones(p.ins.shape[0], np.float32)
                    for p in parts
                ]
            )
        else:
            ins_w = None
        return cls(ins=ins, ins_w=ins_w, dels=dels)

    def __repr__(self):
        return f"Delta(ins={self.ins.shape[0]}, dels={self.dels.shape[0]})"


class Version(Generic[G]):
    __slots__ = ("graph", "aux", "cache", "stamp", "_refcount", "__weakref__")

    def __init__(self, graph: G, stamp: int, aux: Optional[Dict[str, Any]] = None):
        self.graph = graph
        self.aux: Dict[str, Any] = aux if aux is not None else {}
        self.cache: Dict[Any, Any] = {}
        self.stamp = stamp
        self._refcount = 0

    def __repr__(self):
        tags = ",".join(sorted(self.aux)) or "-"
        return f"Version(stamp={self.stamp}, rc={self._refcount}, aux={tags})"


class VersionedGraph(Generic[G]):
    """Multi-version single-writer / multi-reader graph store."""

    def __init__(self, initial: G, aux: Optional[Dict[str, Any]] = None):
        self._lock = threading.Lock()
        self._stamp = 0
        self._versions: Dict[int, Version[G]] = {}
        self._current = Version(initial, 0, aux)
        self._versions[0] = self._current
        self._collected = 0

    # -- reader interface ---------------------------------------------------
    def acquire(self) -> Version[G]:
        """Atomically grab the current version (refcount++)."""
        with self._lock:
            v = self._current
            v._refcount += 1
            return v

    def release(self, v: Version[G]) -> bool:
        """Drop a reference; returns True if this was the last one and the
        version was garbage-collected.

        Idempotent past zero: releasing a version whose refcount has
        already drained (a double-release) is a no-op returning False
        rather than driving the count negative — a negative count would
        keep the version collectible forever while a later acquire/
        release pair races it, corrupting the live list.  (A
        double-release *while other readers still hold the version* is
        indistinguishable from a legitimate release without per-acquire
        tokens; the clamp closes the corrupting case.)"""
        with self._lock:
            if v._refcount <= 0:
                return False
            v._refcount -= 1
            if v._refcount == 0 and v is not self._current:
                self._versions.pop(v.stamp, None)
                self._collected += 1
                return True
            return False

    # -- writer interface ---------------------------------------------------
    def set(self, graph: G, aux: Optional[Dict[str, Any]] = None) -> Version[G]:
        """Publish a new version (single writer).  ``aux`` rides along
        atomically: readers acquiring the new version see the primary
        graph and every auxiliary representation together."""
        with self._lock:
            self._stamp += 1
            nv = Version(graph, self._stamp, aux)
            old = self._current
            self._current = nv
            self._versions[self._stamp] = nv
            if old._refcount == 0:
                self._versions.pop(old.stamp, None)
                self._collected += 1
            return nv

    def update(self, fn: Callable[[G], G]) -> Version[G]:
        """Writer transaction: acquire -> functional update -> set -> release."""
        v = self.acquire()
        try:
            return self.set(fn(v.graph))
        finally:
            self.release(v)

    def update_with_aux(
        self, fn: Callable[[Version[G]], "tuple[G, Optional[Dict[str, Any]]]"]
    ) -> Version[G]:
        """Writer transaction over the full version: ``fn`` sees the held
        (graph, aux) pair and returns the next one — both published as a
        single atomic version."""
        v = self.acquire()
        try:
            graph, aux = fn(v)
            return self.set(graph, aux)
        finally:
            self.release(v)

    # -- deltas --------------------------------------------------------------
    def delta_between(self, v_old: Version[G], v_new: Version[G]) -> Optional[Delta]:
        """The composed edge delta taking ``v_old``'s graph to
        ``v_new``'s, or None when it cannot be derived — any hop already
        collected, or any hop published without a delta record (vertex
        ops, raw writes).  None is the full-recompute signal; an
        incremental consumer holding ``v_old`` (subscriptions and the
        result cache's carry-forward do) always finds the one-hop chain
        intact because the hop's delta lives on ``v_new`` itself."""
        return self.delta_between_stamps(v_old.stamp, v_new.stamp)

    def delta_between_stamps(self, old_stamp: int, new_stamp: int) -> Optional[Delta]:
        """``delta_between`` by stamp: the same chain walk for callers
        that hold stamps rather than version objects (version-holding
        callers get the same liveness guarantee through the stamps —
        only the delta records between the two are consulted)."""
        if new_stamp < old_stamp:
            return None
        if new_stamp == old_stamp:
            return Delta()
        with self._lock:
            parts: List[Delta] = []
            for s in range(old_stamp + 1, new_stamp + 1):
                v = self._versions.get(s)
                if v is None:
                    return None  # hop collected: chain broken
                d = v.aux.get(DELTA)
                if not isinstance(d, Delta):
                    return None  # hop published without a delta record
                parts.append(d)
        return Delta.concat(parts)

    # -- introspection -------------------------------------------------------
    @property
    def current_stamp(self) -> int:
        with self._lock:
            return self._current.stamp

    def live_versions(self) -> int:
        with self._lock:
            return len(self._versions)

    def live_stamps(self) -> List[int]:
        """The stamps of the live versions (the current one and every one
        still held), ascending."""
        with self._lock:
            return sorted(self._versions)

    def collected_versions(self) -> int:
        with self._lock:
            return self._collected
