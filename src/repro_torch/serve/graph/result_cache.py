"""Version-keyed, delta-aware cross-request result cache (DESIGN.md §14).

Counterpart of ``repro/serve/graph/result_cache.py``, on the port's
algorithms.  One change: ``carry_forward`` takes the composed delta
from its caller when the caller kept one (the service records every
hop as it is published), so a promotion that runs several publishes
behind the writer still takes the incremental path.

Aspen's snapshots make every query a pure function of
``(version, kind, params, source)`` — so once one tenant has paid for
an answer on a version, every identical request against that SAME
version can be served from memory.  The cache exploits exactly that and
nothing more:

  * **Key contract.**  The logical key is ``(kind, canonical params,
    source)``; the FULL key includes the version, because entries are
    stored *on* the version: the payload dict lives in
    ``Version.cache[RESULTS]``, so a lookup hands the service a
    ``Version`` object and can, by construction, only ever see results
    computed against that exact snapshot.  A pinned session therefore
    can never read a newer version's cached answer (pinned by test),
    and a freshest read can never resurrect a stale one.

  * **Lifecycle.**  Entries pin nothing.  The payload rides the
    version's own cache dict and is garbage-collected with it through
    the existing ``core.versioning`` refcount hooks; the LRU index here
    holds only ``weakref``s to versions, pruned lazily.  Capacity
    eviction walks the index oldest-first and deletes the payload from
    its (still-live) version.

  * **Delta carry-forward.**  On publish, *hot* entries (ever re-read)
    are promoted to the new version through the incremental paths
    instead of being dropped: ``incremental_bfs`` / ``incremental_sssp``
    / ``incremental_connected_components`` driven by
    ``vg.delta_between``, and warm-started ``pagerank(init=prev)`` when
    the request carries the fixed-point ``tol`` contract.  A broken
    delta chain (``None``) — or fixed-iteration pagerank, whose answer
    is *defined* by the iteration count — falls back to a full
    recompute, run off the request path, so the promoted entry is
    always bit-identical to what a cold serve at the new version would
    have produced (tolerance-identical for ``tol``-pagerank).  A
    publish thus downgrades a hit to a warm-start, not a cold miss.

Thread-safe: one internal lock around the index and the per-version
payload dicts (the service calls in from client threads, executor
threads, and the promotion thread).
"""
from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

# key of the payload dict on Version.cache — everything under it dies
# with the version, like the engine cache next to it
RESULTS = "results"

# widest single promotion dispatch: same-(kind, params) entries are
# carried forward in pow2-padded batches up to this, so promoting N hot
# entries costs ceil(N / 16) batched calls instead of N — and the
# trace ladder warmup (service._warm_promotion) only has to cover 1..16.
# The whole pass bounds the post-publish blind window (entries are warm
# on the old version, cold on the new one until promoted), so fewer,
# wider dispatches matter more than per-dispatch efficiency
PROMOTE_BATCH = 16

# per-kind parameter allowlists the carry-forward path understands; an
# entry whose params fall outside is dropped on publish (never promoted
# wrong), it simply recomputes as a cold miss when next asked for
_PROMOTABLE_PARAMS = {
    "bfs": frozenset(),
    "sssp": frozenset(),
    "cc": frozenset({"direction_optimize", "max_iters"}),
    "pagerank": frozenset({"iters", "damping", "tol", "max_iters"}),
}


class CacheEntry:
    """One cached answer: the host result row plus whatever warm state
    the incremental promotion for its kind needs (bfs keeps the depths
    row computed for free by ``bfs_multi``)."""

    __slots__ = ("value", "state", "hits")

    def __init__(self, value, state=None):
        self.value = value
        self.state = state
        self.hits = 0


class ResultCache:
    """LRU index over version-resident result entries.  See module
    docstring for the key/lifecycle/carry-forward contracts."""

    def __init__(self, capacity: int = 512):
        if capacity < 1:
            raise ValueError("cache capacity must be >= 1")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        # (stamp, kind, pkey, source) -> weakref to the owning Version;
        # insertion order is recency (move_to_end on hit)
        self._lru: "OrderedDict[Tuple, weakref.ref]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.fills = 0
        self.evictions = 0
        self.promoted_incremental = 0
        self.promoted_full = 0
        self.promoted_dropped = 0

    # -- request path --------------------------------------------------------
    def get(self, v, kind: str, pkey: Tuple, source) -> Optional[CacheEntry]:
        """Exact hit against an already-acquired version, else None.
        The payload lookup goes through ``v.cache`` itself, so the hit
        is version-exact by construction."""
        key = (kind, pkey, source)
        with self._lock:
            slot = v.cache.get(RESULTS)
            ent = None if slot is None else slot.get(key)
            if ent is None:
                self.misses += 1
                return None
            self.hits += 1
            ent.hits += 1
            lk = (v.stamp,) + key
            if lk in self._lru:
                self._lru.move_to_end(lk)
            return ent

    def peek(self, v, kind: str, pkey: Tuple, source) -> Optional[CacheEntry]:
        """Presence probe: the entry on ``v`` for this key, without
        counting a hit/miss or touching recency.  The service's capture
        path uses it to ask whether an in-flight promotion pass is
        about to re-derive the very answer a post-publish miss would
        otherwise recompute through the full dispatch path."""
        with self._lock:
            slot = v.cache.get(RESULTS)
            return None if slot is None else slot.get((kind, pkey, source))

    def put(self, v, kind: str, pkey: Tuple, source, value, state=None,
            hits: int = 0) -> None:
        """Record one answer on ``v`` (idempotent per key: a racing
        duplicate fill keeps the first entry's hit count).  ``hits``
        seeds the entry's heat — carry-forward passes the promoted
        entry's count through so a hot entry stays hot across a chain
        of publishes instead of dying one hop in."""
        key = (kind, pkey, source)
        with self._lock:
            slot = v.cache.setdefault(RESULTS, {})
            if key not in slot:
                ent = CacheEntry(value, state)
                ent.hits = hits
                slot[key] = ent
                self.fills += 1
            lk = (v.stamp,) + key
            self._lru[lk] = weakref.ref(v)
            self._lru.move_to_end(lk)
            while len(self._lru) > self.capacity:
                old_lk, vref = self._lru.popitem(last=False)
                owner = vref()
                if owner is not None:
                    owner_slot = owner.cache.get(RESULTS)
                    if owner_slot is not None:
                        owner_slot.pop(old_lk[1:], None)
                    self.evictions += 1
                # a dead weakref's payload died with its version: the
                # index entry is just pruned, not counted as an eviction

    # -- carry-forward -------------------------------------------------------
    def promotable(self, v_old, limit: int) -> List[Tuple[Tuple, CacheEntry]]:
        """The hot entries on ``v_old`` worth carrying across a publish:
        entries that have served at least one hit, most-recently-used
        first, capped at ``limit`` (publish-time work must be bounded)."""
        with self._lock:
            slot = v_old.cache.get(RESULTS)
            if not slot:
                return []
            order = [
                lk[1:] for lk in reversed(self._lru) if lk[0] == v_old.stamp
            ]
            out: List[Tuple[Tuple, CacheEntry]] = []
            for key in order:
                ent = slot.get(key)
                if ent is not None and ent.hits > 0:
                    out.append((key, ent))
                    if len(out) >= limit:
                        break
            return out

    def carry_forward(self, stream, v_old, v_new, backend: str,
                      limit: int = 32, delta=None) -> int:
        """Promote hot ``v_old`` entries onto ``v_new`` through the
        incremental paths (module docstring).  ``delta`` is the composed
        update record from ``v_old`` to ``v_new`` where the caller kept
        one; None asks ``vg.delta_between``, which is None itself when
        a hop between them was collected (the full-recompute signal).
        Runs on the service's promotion thread — never the writer's
        publish callback, whose contract forbids compute.  Returns the
        number promoted."""
        entries = self.promotable(v_old, limit)
        if not entries:
            return 0
        if delta is None:
            delta = stream.vg.delta_between(v_old, v_new)
        eng_new = stream._engine_for(v_new, backend)
        eng_old = None  # fetched lazily: only sssp promotion needs it
        promoted = 0

        def land(key_ents, results):
            nonlocal promoted
            for (key, ent), (value, state, incr) in zip(key_ents, results):
                kind, pkey, source = key
                self.put(v_new, kind, pkey, source, value, state,
                         hits=ent.hits)
                promoted += 1
                if incr:
                    self.promoted_incremental += 1
                else:
                    self.promoted_full += 1

        # bfs/sssp promote as pow2-padded batched dispatches grouped by
        # params — one batched call per PROMOTE_BATCH entries, the same
        # shape discipline as serving; cc/pagerank go one at a time
        groups: "OrderedDict[Tuple, List]" = OrderedDict()
        singles: List[Tuple[Tuple, CacheEntry]] = []
        for (kind, pkey, source), ent in entries:
            if set(dict(pkey)) - _PROMOTABLE_PARAMS.get(kind, frozenset()):
                self.promoted_dropped += 1
                continue
            if kind in ("bfs", "sssp"):
                groups.setdefault((kind, pkey), []).append(
                    ((kind, pkey, source), ent)
                )
            else:
                singles.append(((kind, pkey, source), ent))

        for (kind, pkey), grp in groups.items():
            if (kind == "sssp" and delta is not None and eng_old is None
                    and (eng_new.weighted or delta.has_deletions)):
                eng_old = stream._engine_for(v_old, backend)
            for i in range(0, len(grp), PROMOTE_BATCH):
                chunk = grp[i:i + PROMOTE_BATCH]
                try:
                    results = _promote_batch(
                        eng_old, eng_new, kind, chunk, delta
                    )
                except Exception:
                    # a failed promotion is a dropped chunk, never a
                    # wrong answer (the next request recomputes cold)
                    self.promoted_dropped += len(chunk)
                    continue
                land(chunk, results)

        for (kind, pkey, source), ent in singles:
            try:
                res = _promote_one(
                    eng_new, kind, dict(pkey), source, ent, delta
                )
            except Exception:
                self.promoted_dropped += 1
                continue
            land([((kind, pkey, source), ent)], [res])
        return promoted

    # -- introspection -------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "capacity": self.capacity,
                "entries": len(self._lru),
                "hits": self.hits,
                "misses": self.misses,
                "fills": self.fills,
                "evictions": self.evictions,
                "hit_rate": self.hits / max(self.hits + self.misses, 1),
                "promoted_incremental": self.promoted_incremental,
                "promoted_full": self.promoted_full,
                "promoted_dropped": self.promoted_dropped,
            }


def _pad_b(rows: np.ndarray, m: int) -> np.ndarray:
    """Pad a [k, n] stack to [m, n] by repeating the last row (the
    batch analogue of lane pow2 padding: duplicate lanes are redundant
    work the padded dispatch discards)."""
    k = rows.shape[0]
    if k == m:
        return rows
    return np.concatenate([rows, np.repeat(rows[-1:], m - k, axis=0)])


def _promote_batch(
    eng_old, eng_new, kind: str,
    chunk: List[Tuple[Tuple, CacheEntry]], delta,
) -> List[Tuple[Any, Any, bool]]:
    """Promote one chunk of same-(kind, params) bfs/sssp entries in a
    SINGLE batched dispatch, sources padded to the next power of two so
    promotion replays the warmed trace ladder (service._warm_promotion
    covers 1..PROMOTE_BATCH).  Incremental when the delta supports it,
    batched full recompute otherwise; exact either way."""
    from ...core.traversal import algorithms as talg

    sources = [key[2] for key, _ in chunk]
    k = len(sources)
    m = 1
    while m < k:
        m <<= 1
    pad = sources + [sources[-1]] * (m - k)

    if kind == "bfs":
        if delta is None:
            parents, depths = talg.bfs_multi(eng_new, pad)
            incr = False
        else:
            prev_p = _pad_b(np.stack([ent.value for _, ent in chunk]), m)
            prev_d = _pad_b(np.stack([ent.state for _, ent in chunk]), m)
            parents, depths = talg.incremental_bfs(
                eng_new, pad, prev_p, prev_d, delta
            )
            incr = True
        return [
            (np.asarray(parents[i], np.int64),
             np.asarray(depths[i], np.int64), incr)
            for i in range(k)
        ]

    if kind == "sssp":
        if delta is None:
            dist = talg.sssp_multi(eng_new, pad)
            incr = False
        else:
            prev = _pad_b(np.stack([ent.value for _, ent in chunk]), m)
            if eng_new.weighted or delta.has_deletions:
                # tree derivation is a per-row host pass on the OLD
                # engine: run it on the k real rows only, pad after
                tree = _pad_b(
                    talg.shortest_path_parents(eng_old, prev[:k], sources),
                    m,
                )
            else:
                # unit weights + insert-only delta: the dirty closure
                # is empty no matter what the tree says (inserts only
                # lower distances — prev rows are valid upper bounds
                # the warm relaxation improves), so skip the k dense
                # tree passes and hand the closure a placeholder
                tree = np.full((m, 1), -1, np.int64)
            dist = talg.incremental_sssp(eng_new, pad, prev, tree, delta)
            incr = True
        return [
            (np.asarray(dist[i], np.float64), None, incr) for i in range(k)
        ]

    raise ValueError(f"kind {kind!r} does not batch-promote")


def _promote_one(
    eng_new, kind: str, params: Dict[str, Any], source,
    ent: CacheEntry, delta,
) -> Tuple[Any, Any, bool]:
    """Compute one cc/pagerank entry's value at the new version:
    incremental when the delta supports it, full otherwise — in both
    cases producing exactly what a cold serve at the new version would
    (incremental cc is exact; fixed-iteration pagerank recomputes)."""
    from ...core.traversal import algorithms as talg

    if kind == "cc":
        incremental = delta is not None and not delta.has_deletions
        labels = talg.incremental_connected_components(
            eng_new, ent.value, delta, **params
        )
        return np.asarray(labels, np.int64), None, incremental

    if kind == "pagerank":
        n = eng_new.n
        reset = np.zeros((1, n), np.float64)
        if source is None:
            reset[0, :] = 1.0 / n
        else:
            reset[0, int(source)] = 1.0
        if "tol" in params:
            # fixed-point contract: any init converges to the same
            # scores, so the warm start is tolerance-identical
            scores = talg.pagerank_multi(
                eng_new, resets=reset, init=ent.value[None], **params
            )
            return np.asarray(scores[0]), None, True
        # fixed-iteration pagerank is DEFINED by its iteration count: a
        # warm start would change the answer, so promotion recomputes —
        # still a win: the cost moves off the request path
        scores = talg.pagerank_multi(eng_new, resets=reset, **params)
        return np.asarray(scores[0]), None, False

    raise ValueError(f"unknown kind {kind!r}")
