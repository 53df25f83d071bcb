"""Service observability: per-lane and per-tenant counters.

Port copy of ``repro/serve/graph/metrics.py`` (plain Python).  All
counters are plain ints mutated under the service's dispatch lock (one
writer at a time), snapshotted into dicts by ``service.stats()``.

``LaneMetrics.trace_keys`` is the set of (engine signature, pow2 batch
size) shapes a lane has dispatched; a NEW key after ``mark_warm()``
counts as a retrace.  In the reference those keys are the jit traces of
its traversals.  Eager torch compiles nothing per shape, so here they only
record which shapes the service has dispatched (the same names, so
``stats()["lanes"]`` reads the same); a new engine signature (a pool
that grew its capacity) still shows up as one.
"""
from __future__ import annotations

from typing import Dict, Set, Tuple


class LaneMetrics:
    """Counters for one query kind (aggregated across pinned/freshest
    lane instances of that kind)."""

    __slots__ = (
        "queued", "flushed_batches", "flushed_requests", "batch_hist",
        "deadline_misses", "errors", "trace_keys", "retraces",
        "deadline_flushes", "full_flushes", "idle_flushes",
        "cache_hits", "fastpath_hits", "fastpath_syncs", "capture_hits",
    )

    def __init__(self):
        self.queued = 0              # requests ever placed in a lane
        self.flushed_batches = 0     # lane flushes executed
        self.flushed_requests = 0    # requests those flushes served
        self.batch_hist: Dict[int, int] = {}  # flush size -> count
        self.deadline_misses = 0     # tickets completed past their SLO
        self.errors = 0              # tickets failed by an executor error
        self.trace_keys: Set[Tuple] = set()  # shapes ever dispatched
        self.retraces = 0            # NEW shapes seen after mark_warm()
        self.deadline_flushes = 0    # flushes forced by the half-budget rule
        self.full_flushes = 0        # flushes forced by a full lane
        self.idle_flushes = 0        # work-conserving flushes (idle executor)
        self.cache_hits = 0          # tickets served from the result cache
        self.fastpath_hits = 0       # ...of which at submit time (no lane hop)
        self.fastpath_syncs = 0      # singleton misses served on the caller
        self.capture_hits = 0        # ...hits landed by riding a promotion

    def record_flush(self, size: int, *, reason: str) -> None:
        self.flushed_batches += 1
        self.flushed_requests += size
        self.batch_hist[size] = self.batch_hist.get(size, 0) + 1
        if reason == "deadline":
            self.deadline_flushes += 1
        elif reason == "idle":
            self.idle_flushes += 1
        else:
            self.full_flushes += 1

    def record_trace_key(self, key: Tuple, warm: bool) -> bool:
        """Note a dispatched shape; returns True (and counts a retrace
        when past warmup) if the shape was new."""
        if key in self.trace_keys:
            return False
        self.trace_keys.add(key)
        if warm:
            self.retraces += 1
        return True

    def snapshot(self) -> dict:
        return {
            "queued": self.queued,
            "flushed_batches": self.flushed_batches,
            "flushed_requests": self.flushed_requests,
            "batch_size_hist": dict(sorted(self.batch_hist.items())),
            "deadline_misses": self.deadline_misses,
            "deadline_flushes": self.deadline_flushes,
            "full_flushes": self.full_flushes,
            "idle_flushes": self.idle_flushes,
            "errors": self.errors,
            "trace_keys": len(self.trace_keys),
            "retraces": self.retraces,
            "cache_hits": self.cache_hits,
            "fastpath_hits": self.fastpath_hits,
            "fastpath_syncs": self.fastpath_syncs,
            "capture_hits": self.capture_hits,
        }


class TenantMetrics:
    """``cached`` counts exact-hit requests served without admission:
    those still bump submitted/admitted/completed together (keeping the
    per-tenant accounting identity ``submitted == admitted + rejected +
    backlog`` and ``admitted == completed + in_flight`` snapshot-exact)
    but never advance the tenant's WFQ pass — admission meters MISSES,
    so fairness is arbitrated over real engine work only."""

    __slots__ = ("submitted", "admitted", "completed", "rejected", "cached")

    def __init__(self):
        self.submitted = 0
        self.admitted = 0
        self.completed = 0
        self.rejected = 0
        self.cached = 0

    def snapshot(self, *, weight: float, in_flight: int, backlog: int) -> dict:
        return {
            "weight": weight,
            "submitted": self.submitted,
            "admitted": self.admitted,
            "completed": self.completed,
            "rejected": self.rejected,
            "cached": self.cached,
            "in_flight": in_flight,
            "backlog": backlog,
        }
