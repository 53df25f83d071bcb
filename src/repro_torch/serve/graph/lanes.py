"""Query lanes: coalescing admitted requests into batched dispatches.

Counterpart of ``repro/serve/graph/lanes.py``; the engines are the
port's (``TorchEngine`` / ``CompressedEngine``, ``ShardedEngine`` /
``CompressedShardedEngine``, or numpy).

A *lane* is one homogeneous pending set — requests that can legally
ride a single ``query_batch``-style dispatch.  The lane key is

    (kind, pin, params_key, backend)

where ``pin`` is None for freshest-version lanes (served against the
stream's current version at flush time) or the owning ``Session`` (all
of whose queries must hit its pinned version).  Mixed kinds never
batch; mixed parameters (e.g. two dampings) never batch; pinned and
freshest traffic never batch.

Flush policy (DESIGN.md §13) — a lane flushes when EITHER
  * it holds ``max_batch`` requests (full flush), or
  * the oldest request's deadline budget is half spent:
    now >= t_submit + 0.5 * (deadline - t_submit).
The half-budget rule leaves the other half for the dispatch itself, so
coalescing opportunistically trades latency headroom for batch size but
never spends headroom it doesn't have.

Pagerank pads its reset rows to the next power of two, and the trace
key of a flush names its power-of-two size, so the service sees
O(log max_batch) batch shapes per (kind, engine signature), as the
reference's jitted traversals do.  Eager torch compiles nothing per shape;
the padding fixes the batch shapes the kernels see, and the answers do
not depend on it.
"""
from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from .metrics import LaneMetrics
from .request import QueryTicket

# how much of a request's deadline budget may be spent waiting in a
# lane before the flush is forced
FLUSH_BUDGET_FRACTION = 0.5


def next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def engine_signature(engine) -> Optional[Tuple]:
    """The shape identity of a device engine: vertex count, pool
    capacity (array shapes), weightedness — what, in the reference,
    forces its jitted traversals to recompile.  Returns None for the numpy
    engine, whose shapes the service does not key."""
    g = getattr(engine, "cg", None) or getattr(engine, "g", None)
    if g is not None and hasattr(g, "edge_capacity"):  # TorchEngine / CompressedEngine
        return ("torch", engine.n, int(g.edge_capacity), engine.weighted)
    sg = getattr(engine, "csg", None) or getattr(engine, "sg", None)
    if sg is not None:  # ShardedEngine / CompressedShardedEngine
        return ("sharded", engine.n, (sg.n_shards, sg.pool.cap_per), engine.weighted)
    return None


class Lane:
    """One coalescing point: the pending tickets for a single
    (kind, pin, params, backend) combination, plus the per-KIND metrics
    they report into (lanes of one kind share a ``LaneMetrics``)."""

    __slots__ = ("kind", "pin", "pkey", "backend", "pending", "metrics")

    def __init__(self, kind: str, pin, pkey, backend: str, metrics: LaneMetrics):
        self.kind = kind
        self.pin = pin
        self.pkey = pkey
        self.backend = backend
        self.pending: List[QueryTicket] = []
        self.metrics = metrics

    def add(self, ticket: QueryTicket) -> None:
        self.pending.append(ticket)
        self.metrics.queued += 1

    def flush_at(self) -> float:
        """The instant the half-budget rule forces a flush (+inf when
        empty).  Oldest ticket governs: tickets behind it only ever
        flush earlier than their own budget demands."""
        if not self.pending:
            return float("inf")
        t = self.pending[0]
        return t.t_submit + FLUSH_BUDGET_FRACTION * (t.deadline - t.t_submit)

    def due(self, now: float, max_batch: int) -> bool:
        if not self.pending:
            return False
        return len(self.pending) >= max_batch or now >= self.flush_at()

    def take(self, max_batch: int) -> List[QueryTicket]:
        batch, self.pending = self.pending[:max_batch], self.pending[max_batch:]
        return batch


# ---------------------------------------------------------------------------
# batch execution (runs on the service's executor, engine already pinned)
# ---------------------------------------------------------------------------


def trace_key(kind: str, engine, batch_pow2: int, pkey) -> Optional[Tuple]:
    sig = engine_signature(engine)
    if sig is None:
        return None
    # cc is a whole-graph computation: batch size is not a trace axis
    b = 1 if kind == "cc" else batch_pow2
    return (kind, sig, b, pkey)


def dispatch_pow2(kind: str, tickets: List[QueryTicket]) -> int:
    """The padded batch size this flush will actually trace at."""
    if kind == "cc":
        return 1
    if kind == "pagerank":
        srcs = {t.source for t in tickets}
        return next_pow2(len(srcs))
    uniq = len({t.source for t in tickets})
    return next_pow2(uniq)


def serve_cached(
    cache, version, kind: str, tickets: List[QueryTicket]
) -> List[QueryTicket]:
    """Flush-time cache consult: complete every ticket whose answer is
    already cached on the batch's serving version and return the
    remaining misses.  This is the lane dedup generalized across TIME —
    a source computed by an earlier flush on the same version shrinks
    this dispatch exactly like a duplicate inside it would.  Cached
    tickets report ``batch_size == 0`` (they rode no dispatch)."""
    if cache is None or version is None:
        return tickets
    now = time.perf_counter()
    misses: List[QueryTicket] = []
    for t in tickets:
        ent = cache.get(version, kind, t.pkey, None if kind == "cc" else t.source)
        if ent is None:
            misses.append(t)
            continue
        t.t_flush = now
        t.batch_size = 0
        t.cached = True
        t._complete(ent.value)
    return misses


def execute_batch(
    engine,
    kind: str,
    tickets: List[QueryTicket],
    params: dict,
    cache=None,
    version=None,
) -> None:
    """Serve one flushed batch against an already-acquired engine,
    completing every ticket (the caller fails them all if this raises).

    bfs / sssp dedup identical sources and fan the unique rows back out.
    pagerank
    builds one personalization row per distinct source (one-hot; None =
    the global uniform row) and pads the row count to a power of two
    itself, since ``pagerank_multi`` takes ``resets`` verbatim.  cc runs
    the global computation once and every rider shares the labels.

    With ``cache``/``version`` set, every unique answer is also recorded
    on the serving version (the fill side of ``serve_cached``; bfs
    stashes its depths rows too — the warm state the carry-forward
    ``incremental_bfs`` needs, computed for free by ``bfs_multi``)."""
    from ...core.traversal import algorithms as talg

    now = time.perf_counter()
    for t in tickets:
        t.t_flush = now
        t.batch_size = len(tickets)
    fill = cache is not None and version is not None
    pkey = tickets[0].pkey

    if kind == "cc":
        labels = np.asarray(talg.connected_components(engine, **params), np.int64)
        if fill:
            cache.put(version, kind, pkey, None, labels)
        for t in tickets:
            t._complete(labels)
        return

    if kind == "pagerank":
        order: List[Optional[int]] = []
        row_of = {}
        for t in tickets:
            if t.source not in row_of:
                row_of[t.source] = len(order)
                order.append(t.source)
        n = engine.n
        b = len(order)
        resets = np.zeros((next_pow2(b), n), dtype=np.float64)
        for i, s in enumerate(order):
            if s is None:
                resets[i, :] = 1.0 / n
            else:
                resets[i, s] = 1.0
        # padding rows replay row 0 (a real row: no degenerate all-zero
        # reset reaches ``pagerank_multi``)
        resets[b:, :] = resets[0, :]
        scores = np.asarray(talg.pagerank_multi(engine, resets=resets, **params))
        if fill:
            for s, i in row_of.items():
                cache.put(version, kind, pkey, s, scores[i])
        for t in tickets:
            t._complete(scores[row_of[t.source]])
        return

    sources = np.asarray([t.source for t in tickets], dtype=np.int64)
    uniq, inv = np.unique(sources, return_inverse=True)
    if kind == "bfs":
        rows, depths = talg.bfs_multi(engine, uniq, **params)
        rows = np.asarray(rows, np.int64)
        depths = np.asarray(depths, np.int64)
        if fill:
            for i, s in enumerate(uniq):
                cache.put(version, kind, pkey, int(s), rows[i], state=depths[i])
    elif kind == "sssp":
        rows = np.asarray(talg.sssp_multi(engine, uniq, **params), np.float64)
        if fill:
            for i, s in enumerate(uniq):
                cache.put(version, kind, pkey, int(s), rows[i])
    else:  # pragma: no cover - guarded by QueryTicket validation
        raise ValueError(f"unknown lane kind {kind!r}")
    for t, i in zip(tickets, inv):
        t._complete(rows[i])
