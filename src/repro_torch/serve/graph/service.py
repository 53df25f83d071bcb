"""GraphQueryService: continuous graph updates + SLO-aware batched reads.

Counterpart of ``repro/serve/graph/service.py``: the same threads, lanes,
admission, sessions and result cache, over the port's ``AspenStream``
and its engines (``backend`` defaults to the stream's, the torch engine
on the stream's device).

The service runs the paper's single-writer / many-reader regime as a
long-lived server over one ``AspenStream``:

  * a dedicated WRITER thread drains the bounded update queue in
    batches through ``core.streaming.drain_updates`` — the same loop
    body ``run_concurrent`` uses — publishing each batch atomically as
    one new version;
  * a DISPATCHER thread admits client requests (weighted-fair across
    tenants, in-flight caps) into per-(kind, pin, params) lanes and
    flushes due lanes as power-of-two batched dispatches;
  * an executor pool runs the flushes: freshest-version lanes acquire
    the CURRENT version at flush time (reads never block the writer,
    writer never blocks reads — the paper's snapshot guarantee), while
    session lanes run against their ``Session``'s pinned version.

Flush timing is deadline-driven (lanes.FLUSH_BUDGET_FRACTION): a lane
goes out when full, or when its oldest request has spent half its SLO
budget waiting — so light load degrades to latency-optimal batch size
1 and heavy load coalesces toward ``max_batch`` without ever blowing
deadlines on purpose.  Batches are padded to powers of two, and each
lane keeps the (engine signature, pow2 size) keys it has dispatched
under the reference's names (``record_trace_key``, ``retraces``).  Eager
torch traces nothing, so no zero-retrace contract is held here:
``stats()["jit_traces"]`` reports the port's ``traversal.TRACES``, which
stays 0, and a lane's ``retraces`` counts shapes first dispatched after
``warmup()`` (a pool that grew its capacity is one).

Cross-request result cache (DESIGN.md §14): queries on an unchanged
version are pure functions of (version, kind, params, source), so the
service keeps a version-keyed ``ResultCache`` between the dispatcher
and the engines.  Exact hits are served AT SUBMIT TIME without touching
admission (misses still meter WFQ fairness — cache luck must not starve
anyone's real work), lanes consult the cache at flush time to shrink
the dispatched batch, and a PROMOTION thread carries hot entries across
publishes through the delta-aware incremental paths (the ``on_publish``
listener only sets an event and keeps a reference to the hop's delta
record — the writer never computes; with the recorded hops a pass that
runs several publishes behind still promotes incrementally).  The
opt-in ``fastpath`` mode additionally serves singleton misses
synchronously on the caller thread when the executor is idle (batch=1
without the lane/ticket/executor hop); like ``work_conserving`` it is
off by default to keep flush accounting deterministic.

Across ``torch.distributed`` ranks (a ``mirror="sharded"`` stream whose
rows the ranks of the process group that ``launch.mesh.init_ranks``
started share, more than one of them): every rank builds
``GraphQueryService(stream, backend="sharded", ...)`` with the same
arguments and calls ``start()`` / ``stop()``.  The stream's own mesh
says so (``collective.lane_world``); another backend over such a
stream, or ``backend="sharded"`` over a stream that is not sharded
across the ranks, raises.  On rank 0 it is the
service above: admission, tenancy, deadlines, the result cache and its
hits, sessions and the batching all stay there, and every call that
reaches a collective (a publish, a flush, the fast path, a promotion
pass, warmup, a subscription's open, refresh and close) runs as one op
of the collective lane (``collective.py``), which broadcasts the op's
descriptor to the other ranks before it runs it.  On every other rank
``start()`` runs the follower loop, which runs the descriptors it
receives, until rank 0 stops; ``submit`` raises there.  A request rank 0
rejects never reaches a follower, nor does a cache hit.  With no process
group (or one rank, or a stream that is not sharded across the ranks,
served by another backend) the service is the one above, unchanged.
"""
from __future__ import annotations

import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ...core.streaming import AspenStream, StampHolds, UpdateQueue, apply_updates, drain_updates
from ...core.traversal import TRACES
from ...core.versioning import DELTA, Delta

from . import collective as C
from . import lanes as L
from .admission import AdmissionQueue, QueueFull
from .metrics import LaneMetrics
from .request import KINDS, QueryTicket, params_key
from .result_cache import PROMOTE_BATCH, RESULTS, ResultCache
from .sessions import Session

__all__ = ["GraphQueryService", "QueueFull"]

_MISSING = object()  # a hop whose listener call has not been recorded


def _no_send(desc: dict) -> None:
    """The descriptor sink of a service on one rank: nothing to tell."""


def _delta_wire(d: Optional[Delta]):
    return None if d is None else (d.ins, d.ins_w, d.dels)


def _delta_of_wire(w) -> Optional[Delta]:
    return None if w is None else Delta(ins=w[0], ins_w=w[1], dels=w[2])


class GraphQueryService:
    """See module docstring.  Lifecycle::

        service = GraphQueryService(stream, max_batch=64)
        service.start()          # or: with GraphQueryService(stream) as s:
        service.warmup()
        t = service.submit("bfs", source=0, tenant="alice")
        parents = t.result(timeout=5.0)
        service.stop()
    """

    def __init__(
        self,
        stream: AspenStream,
        backend: Optional[str] = None,
        max_batch: int = 64,
        n_workers: int = 1,
        default_deadline_s: float = 0.25,
        update_batch: int = 256,
        update_queue_size: Optional[int] = 65536,
        symmetric_updates: bool = True,
        tenant_weights: Optional[Dict[str, float]] = None,
        max_inflight_per_tenant: int = 256,
        max_inflight_total: int = 1024,
        max_backlog: int = 8192,
        poll_interval_s: float = 0.010,
        work_conserving: bool = False,
        result_cache: bool = True,
        cache_capacity: int = 512,
        carry_forward: bool = True,
        carry_limit: int = 32,
        fastpath: bool = False,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.stream = stream
        self.backend = backend if backend is not None else stream._default_backend()
        self.max_batch = int(max_batch)
        self.default_deadline_s = float(default_deadline_s)
        self.update_batch = int(update_batch)
        self.symmetric_updates = symmetric_updates
        self.updates = UpdateQueue(maxsize=update_queue_size)
        self._poll = poll_interval_s
        # work-conserving mode: when the executor sits idle, flush
        # whatever is pending instead of waiting out the half-budget
        # timer (continuous batching a la the decode server — batch
        # size adapts to arrival rate; the deadline rule still bounds
        # queueing when the executor is busy).  Off by default: the
        # strict policy gives deterministic flush accounting.
        self.work_conserving = work_conserving
        self._active_flushes = 0
        # under ranks: rank 0 runs the service, the others follow its
        # descriptors (module docstring); every rank makes the control
        # group here, at the same point
        self._rank, self._world = C.lane_world(stream, self.backend)
        self._lane: Optional[C.CollectiveLane] = None
        self._lane_error: Optional[BaseException] = None
        # (op, stamp) per op of the collective lane: rank 0's sent, a
        # follower's run (equal on every rank of a run)
        self.op_log: List[Tuple[str, int]] = []
        self._subscriptions = 0  # lane subscriptions opened (their ids)
        if self._world > 1:
            from ...launch import mesh as mesh_lib

            mesh_lib.control_group()
        # cross-request result cache + delta carry-forward (DESIGN.md §14);
        # a follower's copy evicts only what rank 0 evicted
        self._cache = None
        if result_cache:
            self._cache = (ResultCache(sys.maxsize) if self._rank else
                           ResultCache(cache_capacity, log_evictions=self._world > 1))
        self._carry = bool(carry_forward) and result_cache
        self._carry_limit = int(carry_limit)
        self._fastpath = bool(fastpath)
        self._anchor = None  # the promotion thread's held previous version
        # stamp -> that publish's delta record (None: published without
        # one), for the stamps past the anchor: the promotion's own copy
        # of the chain, which ``vg.delta_between`` loses once an unheld
        # hop is collected
        self._hops: Dict[int, Optional[Delta]] = {}
        # promotion passes that raised outside carry_forward's per-chunk
        # guards (its own failures count in promoted_dropped), and the
        # last such error
        self._promote_errors = 0
        self._promote_error: Optional[str] = None

        self._lock = threading.RLock()
        self._admission = AdmissionQueue(
            weights=tenant_weights,
            max_inflight_per_tenant=max_inflight_per_tenant,
            max_inflight_total=max_inflight_total,
            max_backlog=max_backlog,
        )
        self._lanes: Dict[Tuple, L.Lane] = {}
        self._kind_metrics: Dict[str, LaneMetrics] = {k: LaneMetrics() for k in KINDS}
        self._sessions: set = set()
        self._warm = False
        self._publishes = 0
        self._unsubscribe = None

        self._running = False
        self._draining = False
        self._writer_busy = False
        self._stop_writer = threading.Event()
        self._stop_dispatcher = threading.Event()
        self._wake = threading.Event()
        self._idle = threading.Condition(self._lock)
        self._executor: Optional[ThreadPoolExecutor] = None
        self._writer: Optional[threading.Thread] = None
        self._dispatcher: Optional[threading.Thread] = None
        self._promoter: Optional[threading.Thread] = None
        self._stop_promoter = threading.Event()
        self._promote_wake = threading.Event()
        self._promoting = False
        # capture waiters: post-publish misses whose key the in-flight
        # promotion pass is about to re-derive park here briefly
        # instead of re-entering the dispatch path (leaf lock)
        self._promo_cv = threading.Condition(threading.Lock())
        self._n_workers = int(n_workers)

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "GraphQueryService":
        """Start the threads; on a follower rank, run the follower loop
        until rank 0 stops (then return)."""
        if self._rank != 0:
            self._follow()
            return self
        with self._lock:
            if self._running:
                return self
            self._running = True
            self._draining = False
            self._lane_error = None
        if self._world > 1:
            self._lane = C.CollectiveLane(self.stream.vg.live_stamps, self._lane_extras,
                                          self._lane_stamp, self._lane_fault, self.op_log)
            self._lane.start()
        self._stop_writer.clear()
        self._stop_dispatcher.clear()
        self._unsubscribe = self.stream.on_publish(self._on_publish)
        self._executor = ThreadPoolExecutor(
            max_workers=self._n_workers, thread_name_prefix="graph-serve"
        )
        self._writer = threading.Thread(
            target=self._writer_loop, name="graph-serve-writer", daemon=True
        )
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, name="graph-serve-dispatch", daemon=True
        )
        self._writer.start()
        self._dispatcher.start()
        if self._cache is not None and self._carry:
            # the anchor is the version whose cached answers the next
            # carry-forward reads from; the promotion thread rotates it
            # publish by publish (never the writer's callback)
            self._anchor = self.stream.acquire()
            self._stop_promoter.clear()
            self._promote_wake.clear()
            self._promoter = threading.Thread(
                target=self._promote_loop, name="graph-serve-promote", daemon=True
            )
            self._promoter.start()
        return self

    def stop(self, timeout: float = 30.0) -> None:
        """Graceful shutdown: stop accepting work, flush every queued
        ticket to completion, stop the writer after its current batch
        (leftover update-queue depth stays visible in ``stats()``),
        join the threads.  Idempotent."""
        with self._lock:
            if not self._running:
                return
            self._running = False     # submissions now rejected
            self._draining = True     # dispatcher flushes all lanes eagerly
        self._wake.set()
        deadline = time.perf_counter() + timeout
        with self._lock:
            self._idle.wait_for(
                self._drained_locked, timeout=max(0.0, deadline - time.perf_counter())
            )
        self._stop_dispatcher.set()
        self._stop_writer.set()
        self._wake.set()
        if self._dispatcher is not None:
            self._dispatcher.join(timeout=5.0)
        if self._writer is not None:
            self._writer.join(timeout=5.0)
        self._stop_promoter.set()
        self._promote_wake.set()
        if self._promoter is not None:
            self._promoter.join(timeout=5.0)
            self._promoter = None
        if self._anchor is not None:
            self.stream.release(self._anchor)
            self._anchor = None
        with self._promo_cv:  # capture waiters must not sit out the cap
            self._promo_cv.notify_all()
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None
        if self._lane is not None:
            self._lane.stop()
        if self._unsubscribe is not None:
            self._unsubscribe()
            self._unsubscribe = None
        with self._lock:
            self._hops.clear()

    def __enter__(self) -> "GraphQueryService":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _drained_locked(self) -> bool:
        return (
            self._admission.backlog_depth() == 0
            and self._admission.in_flight_total == 0
        )

    # -- update side ---------------------------------------------------------
    def enqueue_update(
        self,
        src: int,
        dst: int,
        delete: bool = False,
        weight: Optional[float] = None,
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> bool:
        """Queue one edge mutation for the writer thread (the bounded
        queue is the backpressure surface: ``block=False`` on a full
        queue rejects and returns False)."""
        ok = self.updates.put(
            src, dst, delete=delete, weight=weight, block=block, timeout=timeout
        )
        return ok

    def insert_edges(self, edges: np.ndarray, block: bool = True) -> int:
        n = 0
        for s, d in np.asarray(edges, dtype=np.int64).reshape(-1, 2):
            n += bool(self.enqueue_update(int(s), int(d), block=block))
        return n

    def delete_edges(self, edges: np.ndarray, block: bool = True) -> int:
        n = 0
        for s, d in np.asarray(edges, dtype=np.int64).reshape(-1, 2):
            n += bool(self.enqueue_update(int(s), int(d), delete=True, block=block))
        return n

    def _writer_loop(self) -> None:
        while not self._stop_writer.is_set():
            # the busy flag must go up BEFORE the drain pops (a popped-
            # but-unpublished batch is invisible in queue depth, and an
            # apply can take a while) — it is what makes flush_updates a
            # real publish barrier
            self._writer_busy = True
            try:
                k = self._drain_once()
            except C.LaneFault:
                return  # the service stopped with the lane
            finally:
                self._writer_busy = False
            if k == 0:
                self.updates.wait_nonempty(timeout=0.005)

    def _drain_once(self) -> int:
        if self._lane is None:
            return drain_updates(self.updates, self.stream, self.update_batch,
                                 symmetric=self.symmetric_updates)
        rows = self.updates.pop_batch(self.update_batch)
        if not rows:
            return 0

        def publish(send):
            send({"op": "publish", "rows": rows})
            return apply_updates(self.stream, rows, self.symmetric_updates)

        return self._lane.run(publish)

    def _on_publish(self, v) -> None:
        # runs on the WRITER thread: the on_publish contract forbids
        # compute here, so carry-forward work only gets SIGNALLED (and
        # the hop's delta record kept, a reference)
        with self._lock:
            self._publishes += 1
            # a pass that already rotated past this stamp took its record
            # from the version itself (``_hop_chain``): nothing to keep
            a = self._anchor
            if self._carry and (a is None or v.stamp > a.stamp):
                self._hops[v.stamp] = v.aux.get(DELTA)
        if self._carry:
            self._promote_wake.set()

    def flush_updates(self, timeout: float = 30.0) -> None:
        """Block until every update queued so far has been PUBLISHED
        (writer catch-up barrier for tests / benchmarks).  Queue depth
        alone is not enough — the writer pops a batch before applying
        it — so this also waits out the busy flag the writer raises
        around each drain."""
        deadline = time.perf_counter() + timeout
        while len(self.updates) > 0 or self._writer_busy:
            if time.perf_counter() > deadline:
                raise TimeoutError(
                    f"writer did not drain {len(self.updates)} updates in {timeout}s"
                )
            time.sleep(0.001)

    # -- carry-forward promotion ---------------------------------------------
    def _promote_loop(self) -> None:
        """Promotion thread: after each publish, carry hot cache
        entries from the held anchor version onto the current one
        through the incremental paths, then rotate the anchor.  At most
        one superseded version stays alive per rotation, so
        ``live_versions`` stays bounded under a continuous writer."""
        while not self._stop_promoter.is_set():
            self._promote_wake.wait(timeout=0.05)
            self._promote_wake.clear()
            if self._stop_promoter.is_set():
                break
            self._promote_once()

    def _hop_chain(self, anchor, cur) -> Optional[Delta]:
        """The update record from ``anchor`` to ``cur`` composed, or None
        when a hop has none (a vertex op published it, or its version was
        collected before its listener call ran).  The last hop comes from
        ``cur`` itself, which the pass holds: the writer makes a version
        current before it calls the listeners, so the pass may run in
        between.  The hops before it come from the listener's records,
        else from the version graph while their versions live."""
        with self._lock:
            parts = [self._hops.get(s, _MISSING) for s in range(anchor.stamp + 1, cur.stamp)]
        for i, d in enumerate(parts):
            if d is _MISSING:
                parts[i] = self.stream.vg.delta_between_stamps(anchor.stamp + i,
                                                               anchor.stamp + i + 1)
        parts.append(cur.aux.get(DELTA))
        if not all(isinstance(d, Delta) for d in parts):
            return None
        return Delta.concat(parts)

    def _promote_once(self) -> None:
        anchor = self._anchor
        if anchor is None or self._cache is None:
            return
        cur = self.stream.acquire()
        if cur.stamp == anchor.stamp:
            self.stream.release(cur)
            return
        self._promoting = True

        def promote(send):
            def announce(entries, delta):
                send({"op": "promote", "stamp": cur.stamp, "anchor": anchor.stamp,
                      "keys": [key for key, _ in entries], "delta": _delta_wire(delta)})

            # the writer may have published several times since the last
            # pass, and nobody holds the versions in between; the recorded
            # hops keep the chain (the reference asks only
            # ``vg.delta_between`` and then recomputes in full)
            return self._cache.carry_forward(
                self.stream, anchor, cur, self.backend, limit=self._carry_limit,
                delta=self._hop_chain(anchor, cur), announce=announce,
            )

        try:
            self._on_lane(promote)
        except Exception as exc:  # noqa: BLE001 - counted in stats()
            # a failed round degrades hot entries to cold misses
            with self._lock:
                self._promote_errors += 1
                self._promote_error = f"{type(exc).__name__}: {exc}"
        finally:
            with self._lock:  # the listener reads the anchor under this lock
                self._anchor = cur
                for s in [s for s in self._hops if s <= cur.stamp]:
                    del self._hops[s]
            self.stream.release(anchor)
            self._promoting = False
            # release the capture waiters first (their retry lookup is
            # the cheapest path to completion), then wake the
            # dispatcher so miss tickets that raced into lanes get
            # rescued by the flush-time consult instead of waiting out
            # the flush policy
            with self._promo_cv:
                self._promo_cv.notify_all()
            self._wake.set()

    def flush_promotions(self, timeout: float = 30.0) -> None:
        """Block until carry-forward has caught up with the writer's
        current version — the cache-side sibling of ``flush_updates``
        (promotion barrier for tests / deterministic replays).  No-op
        when the cache or carry-forward is off."""
        if self._cache is None or not self._carry:
            return
        deadline = time.perf_counter() + timeout
        while True:
            anchor = self._anchor
            if (
                anchor is not None
                and anchor.stamp >= self.stream.vg.current_stamp
                and not self._promoting
            ):
                return
            if time.perf_counter() > deadline:
                raise TimeoutError("carry-forward did not catch up in time")
            self._promote_wake.set()
            time.sleep(0.001)

    # -- query side ----------------------------------------------------------
    def submit(
        self,
        kind: str,
        source: Optional[int] = None,
        tenant: str = "default",
        deadline_s: Optional[float] = None,
        session: Optional[Session] = None,
        **params: Any,
    ) -> QueryTicket:
        """Submit one query; returns the ticket to block on.  Raises
        ``QueueFull`` when the tenant's backlog is at capacity (the
        client-visible backpressure signal).

        An exact result-cache hit (same version, kind, params, source)
        completes the ticket right here — no admission, no lane, no
        executor hop (``ticket.cached`` / ``ticket.fastpath``, batch
        size 0).  Misses are metered through admission as before; with
        ``fastpath=True`` a singleton miss on a fully idle service is
        additionally served synchronously on the calling thread."""
        budget = self.default_deadline_s if deadline_s is None else float(deadline_s)
        ticket = QueryTicket(
            tenant, kind, source, params,
            deadline=time.perf_counter() + budget,
            session=session,
        )
        hit_value = None
        sync = False
        capture = 0
        with self._lock:
            if not self._running:
                if self._rank != 0:
                    raise RuntimeError(f"rank {self._rank} follows rank 0: submit on rank 0")
                raise RuntimeError("service is not running")
            if self._cache is not None:
                ent = self._cache_lookup_locked(ticket, session)
                if ent is not None:
                    self._meter_hit_locked(ticket)
                    hit_value = ent.value
                elif session is None and self._carry:
                    # post-publish blind window: if the key this miss
                    # wants is hot on the promotion anchor, the pass in
                    # flight is about to re-derive it — park on the
                    # pass instead of recomputing through dispatch
                    anchor = self._anchor
                    cur_stamp = self.stream.vg.current_stamp
                    if anchor is not None and (
                        anchor.stamp < cur_stamp or self._promoting
                    ):
                        skey = (
                            None if ticket.kind == "cc" else ticket.source
                        )
                        prev = self._cache.peek(
                            anchor, ticket.kind, ticket.pkey, skey
                        )
                        if prev is not None and prev.hits > 0:
                            capture = cur_stamp
            if hit_value is None and not capture:
                sync = self._admit_locked(ticket)
        if hit_value is not None:
            self._finish_hit(ticket, hit_value, session)
            return ticket
        if capture:
            return self._capture_wait(ticket, session, capture)
        if sync:
            self._run_sync(ticket)
            return ticket
        self._wake.set()
        return ticket

    def _meter_hit_locked(self, ticket: QueryTicket) -> None:
        # meter the tenant ledger (the TenantMetrics identity
        # invariants stay snapshot-exact) but never its WFQ pass:
        # admission arbitrates real engine work only
        tm = self._admission.tenant(ticket.tenant).metrics
        tm.submitted += 1
        tm.admitted += 1
        tm.completed += 1
        tm.cached += 1
        m = self._kind_metrics[ticket.kind]
        m.cache_hits += 1
        m.fastpath_hits += 1

    def _admit_locked(self, ticket: QueryTicket) -> bool:
        """Meter the miss through admission; True when the fastpath
        claimed it for synchronous execution on the caller thread."""
        self._admission.submit(ticket)
        if (
            self._fastpath
            and self._admission.in_flight_total == 0
            and self._active_flushes == 0
            and self._admission.backlog_depth() == 1
        ):
            # idle service, our ticket is the whole backlog: admit it
            # (vpass advances — it IS real work) and run it on this
            # thread, skipping the executor hop
            if self._admission.admit(max_n=1):
                return True
        return False

    @staticmethod
    def _finish_hit(ticket: QueryTicket, value, session) -> None:
        ticket.t_flush = time.perf_counter()
        ticket.batch_size = 0
        ticket.cached = True
        ticket.fastpath = True
        ticket._complete(value)
        if session is not None:
            session._query_done(ticket)

    # longest a captured miss parks on an in-flight promotion pass
    # before giving up and dispatching normally — the common wait is
    # one batched incremental dispatch, a few ms
    CAPTURE_WAIT_S = 0.1

    def _capture_wait(
        self, ticket: QueryTicket, session, stamp: int
    ) -> QueryTicket:
        """Park a post-publish miss until the in-flight carry-forward
        pass lands, then retry the lookup.  Without this, every publish
        turns the whole hot set cold at once and every closed-loop
        client recomputes its hot key through the full dispatch path —
        duplicating the promotion work and convoying the executor; with
        it, the storm rides ONE batched promotion."""
        end = min(time.perf_counter() + self.CAPTURE_WAIT_S, ticket.deadline)
        with self._promo_cv:
            while True:
                a = self._anchor
                if a is None or (a.stamp >= stamp and not self._promoting):
                    break
                left = end - time.perf_counter()
                if left <= 0:
                    break
                self._promo_cv.wait(left)
        hit_value = None
        sync = False
        with self._lock:
            if not self._running:
                raise RuntimeError("service is not running")
            ent = (
                None if self._cache is None
                else self._cache_lookup_locked(ticket, session)
            )
            if ent is not None:
                self._meter_hit_locked(ticket)
                self._kind_metrics[ticket.kind].capture_hits += 1
                hit_value = ent.value
            else:
                sync = self._admit_locked(ticket)
        if hit_value is not None:
            self._finish_hit(ticket, hit_value, session)
            return ticket
        if sync:
            self._run_sync(ticket)
            return ticket
        self._wake.set()
        return ticket

    def _cache_lookup_locked(self, ticket: QueryTicket, session):
        """Exact-hit lookup against the version this ticket would be
        served on: the session's pinned version, or the stream's current
        one — so a pinned session can never see a newer version's cached
        answer, and a freshest read never a stale one."""
        skey = None if ticket.kind == "cc" else ticket.source
        if session is not None:
            return self._cache.get(session.version, ticket.kind, ticket.pkey, skey)
        a = self._anchor
        if a is not None and a is self.stream.vg._current:
            # the promotion anchor IS the current version and the
            # service already holds a ref: skip the acquire/release
            # round trip through the version-graph lock (the hot hit
            # path runs per request; a publish racing past the
            # identity check linearizes the same way it would racing
            # past an acquire)
            return self._cache.get(a, ticket.kind, ticket.pkey, skey)
        v = self.stream.acquire()
        try:
            return self._cache.get(v, ticket.kind, ticket.pkey, skey)
        finally:
            self.stream.release(v)

    def _run_sync(self, ticket: QueryTicket) -> None:
        """Opt-in batch=1 fast path: the executor is idle and nothing
        else is queued, so serve the singleton miss on the CALLER
        thread.  The ticket went through admission normally; only the
        lane wait and the executor handoff are skipped."""
        session = ticket.session
        m = self._kind_metrics[ticket.kind]
        error: Optional[BaseException] = None

        def fast(send):
            v = None
            try:
                if session is not None:
                    ver = session.version
                else:
                    v = self.stream.acquire()
                    ver = v
                with self._lock:
                    m.fastpath_syncs += 1
                ticket.fastpath = True
                send(self._batch_desc("fast", ver, ticket.kind, [ticket], ticket.params))
                self._exec_batch(ver, ticket.kind, [ticket], dict(ticket.params), m)
            finally:
                if v is not None:
                    self.stream.release(v)

        try:
            self._on_lane(fast)
        except BaseException as exc:  # noqa: BLE001 - surfaces at result()
            error = exc
            if not ticket.done():
                ticket._fail(exc)
        finally:
            with self._lock:
                self._admission.complete(ticket)
                if error is None and ticket.deadline_missed:
                    m.deadline_misses += 1
                if error is not None:
                    m.errors += 1
                self._idle.notify_all()
            if session is not None:
                session._query_done(ticket)

    def query(self, kind: str, source: Optional[int] = None, timeout: float = 30.0,
              **kw) -> np.ndarray:
        """Blocking convenience: submit + wait."""
        return self.submit(kind, source=source, **kw).result(timeout=timeout)

    def session(self, tenant: str = "default") -> Session:
        """Open a snapshot-pinned session (see ``sessions.Session``)."""
        with self._lock:
            if not self._running:
                raise RuntimeError("service is not running")
            s = Session(self, tenant)
            self._sessions.add(s)
        return s

    def _forget_session(self, s: Session) -> None:
        with self._lock:
            self._sessions.discard(s)

    # -- dispatcher ----------------------------------------------------------
    def _lane_for(self, ticket: QueryTicket) -> L.Lane:
        key = (ticket.kind, ticket.session, ticket.pkey, self.backend)
        lane = self._lanes.get(key)
        if lane is None:
            lane = L.Lane(
                ticket.kind, ticket.session, ticket.pkey, self.backend,
                self._kind_metrics[ticket.kind],
            )
            self._lanes[key] = lane
        return lane

    def _dispatch_loop(self) -> None:
        while not self._stop_dispatcher.is_set():
            batches: List[Tuple[L.Lane, List[QueryTicket]]] = []
            with self._lock:
                for t in self._admission.admit():
                    self._lane_for(t).add(t)
                now = time.perf_counter()
                next_due = float("inf")
                for key in list(self._lanes):
                    lane = self._lanes[key]
                    if not lane.pending:
                        del self._lanes[key]
                        continue
                    if self._draining or lane.due(now, self.max_batch):
                        reason = (
                            "full"
                            if len(lane.pending) >= self.max_batch
                            else "deadline"
                        )
                        batch = lane.take(self.max_batch)
                        lane.metrics.record_flush(len(batch), reason=reason)
                        batches.append((lane, batch))
                        if lane.pending:
                            next_due = min(next_due, lane.flush_at())
                    else:
                        next_due = min(next_due, lane.flush_at())
                if self.work_conserving and not self._draining:
                    # fill free executor slots with the oldest waiting
                    # lanes: batch size adapts to arrival rate instead
                    # of stalling on the half-budget timer
                    while self._active_flushes + len(batches) < self._n_workers:
                        waiting = [l for l in self._lanes.values() if l.pending]
                        if not waiting:
                            break
                        lane = min(waiting, key=lambda l: l.pending[0].t_submit)
                        batch = lane.take(self.max_batch)
                        lane.metrics.record_flush(len(batch), reason="idle")
                        batches.append((lane, batch))
                self._active_flushes += len(batches)
            for lane, batch in batches:
                self._executor.submit(self._run_flush, lane, batch)
            if batches:
                continue  # more work may be admissible right away
            wait = self._poll
            if next_due != float("inf"):
                wait = min(wait, max(0.0, next_due - time.perf_counter()))
            self._wake.wait(timeout=max(wait, 0.0005))
            self._wake.clear()

    def _run_flush(self, lane: L.Lane, batch: List[QueryTicket]) -> None:
        """Executor job: pin the serving version (freshest or session),
        consult the result cache (flush-time dedup across time: hits
        drop out of the dispatch), note the trace key for the SHRUNK
        batch, execute, then settle accounting."""
        params = dict(batch[0].params)
        n_cached = 0
        error: Optional[BaseException] = None

        def flush(send):
            nonlocal n_cached
            v = None
            try:
                if lane.pin is not None:
                    ver = lane.pin.version
                else:
                    v = self.stream.acquire()
                    ver = v
                live = L.serve_cached(self._cache, ver, lane.kind, batch)
                n_cached = len(batch) - len(live)
                if live:
                    send(self._batch_desc("flush", ver, lane.kind, live, params))
                    self._exec_batch(ver, lane.kind, live, params, lane.metrics)
            finally:
                if v is not None:
                    self.stream.release(v)

        try:
            self._on_lane(flush)
        except BaseException as exc:  # noqa: BLE001 - fail the tickets, not the service
            error = exc
            for t in batch:
                if not t.done():
                    t._fail(exc)
        finally:
            with self._lock:
                self._active_flushes -= 1
                lane.metrics.cache_hits += n_cached
                for t in batch:
                    self._admission.complete(t)
                    if error is None and t.deadline_missed:
                        lane.metrics.deadline_misses += 1
                if error is not None:
                    lane.metrics.errors += len(batch)
                self._idle.notify_all()
            for t in batch:
                if t.session is not None:
                    t.session._query_done(t)
            self._wake.set()

    def wait_idle(self, timeout: float = 30.0) -> None:
        """Block until no queued or in-flight queries remain."""
        deadline = time.perf_counter() + timeout
        with self._lock:
            if not self._idle.wait_for(
                self._drained_locked, timeout=max(0.0, deadline - time.perf_counter())
            ):
                raise TimeoutError("service did not go idle in time")

    def _exec_batch(self, ver, kind: str, tickets: List[QueryTicket], params: dict,
                    metrics: Optional[LaneMetrics]) -> None:
        """Serve a batch on the held version ``ver`` (every rank runs it):
        the engine (built here on its first query), the trace key, the
        batched dispatch and the cache fill."""
        eng = self.stream._engine_for(ver, self.backend)
        key = L.trace_key(kind, eng, L.dispatch_pow2(kind, tickets), tickets[0].pkey)
        if key is not None and metrics is not None:
            with self._lock:
                metrics.record_trace_key(key, warm=self._warm)
        L.execute_batch(eng, kind, tickets, params, cache=self._cache, version=ver)

    # -- the collective lane (under ranks; collective.py) ----------------------
    def _on_lane(self, fn):
        """``fn(send)`` as one op of the collective lane under ranks, else
        here and now with a ``send`` that tells nobody."""
        if self._lane is None:
            return fn(_no_send)
        return self._lane.run(fn)

    @staticmethod
    def _batch_desc(op: str, ver, kind: str, tickets: List[QueryTicket], params) -> dict:
        return {"op": op, "stamp": ver.stamp, "kind": kind,
                "sources": [t.source for t in tickets], "params": dict(params)}

    def _lane_extras(self) -> dict:
        return {"evict": [] if self._cache is None else self._cache.take_evicted()}

    def _lane_stamp(self, desc: dict) -> int:
        return desc.get("stamp", self.stream.vg.current_stamp)

    def _lane_fault(self, exc: BaseException) -> None:
        """The lane stopped on a fault: take no more requests (queued
        tickets fail as their flushes reach the stopped lane)."""
        with self._lock:
            self._lane_error = exc
            self._running = False
        self._wake.set()

    def _follow(self) -> None:
        """A follower rank's service: run rank 0's descriptors until
        ``stop`` (``collective.follow``), each logged in ``op_log``."""
        holds = StampHolds(self.stream)
        subs: Dict[int, Any] = {}

        def handle(desc: dict) -> int:
            released = holds.retain(desc["live"])
            if self._cache is not None:
                self._cache.forget(released)
                for stamp, kind, pkey, source in desc.get("evict", ()):
                    if stamp in holds:
                        self._cache.drop(holds[stamp], kind, pkey, source)
            op = desc["op"]
            if op == "publish":
                apply_updates(self.stream, desc["rows"], self.symmetric_updates)
                return holds.hold_current().stamp
            if op in ("keepalive", "release", "stop"):
                return self.stream.vg.current_stamp
            if op in ("subscribe", "refresh", "unsubscribe"):
                return self._follow_subscription(desc, subs)
            ver = holds[desc["stamp"]]
            if op in ("flush", "fast"):
                kind, params = desc["kind"], desc["params"]
                tickets = [QueryTicket("_rank", kind, s, params, deadline=float("inf"))
                           for s in desc["sources"]]
                self._exec_batch(ver, kind, tickets, dict(params), None)
            elif op == "warmup":
                self._warm_body(ver, desc["kinds"], desc["params"])
            elif op == "promote":
                anchor = holds[desc["anchor"]]
                slot = anchor.cache[RESULTS]
                entries = [(tuple(k), slot[tuple(k)]) for k in desc["keys"]]
                self._cache.carry_entries(self.stream, anchor, ver, self.backend, entries,
                                          _delta_of_wire(desc["delta"]))
            else:
                raise C.LaneFault(f"unknown op {op!r}")
            return ver.stamp

        try:
            C.follow(handle, self.op_log)
        finally:
            for sub in subs.values():
                sub.close()
            holds.close()

    def _follow_subscription(self, desc: dict, subs: Dict[int, Any]) -> int:
        op, sid = desc["op"], desc["id"]
        if op == "subscribe":
            subs[sid] = self.stream.subscribe(desc["kind"], sources=desc["sources"],
                                              backend=self.backend, **desc["params"])
        elif op == "refresh":
            subs[sid].refresh()
        else:
            sub = subs.pop(sid)
            sub.close()
            return sub.stamp
        return subs[sid].stamp

    def subscribe(self, kind: str, sources=None, **params):
        """A live subscription (``core.streaming.Subscription``) on the
        service's stream and backend.  Under ranks its open, each
        ``refresh()`` and ``close()`` run as ops of the collective lane
        (the service must be running)."""
        if self._lane is None:
            return self.stream.subscribe(kind, sources=sources, backend=self.backend,
                                         **params)
        return _LaneSubscription(self, kind, sources, params)

    # -- warmup & observability ---------------------------------------------
    def warmup(self, kinds=KINDS, **params: Any) -> None:
        """Run the power-of-two ladder once: one synthetic dispatch per
        (kind, pow2 size <= max_batch) against the current version, then
        flip warm — from here on any NEW trace key counts as a retrace
        in ``stats()``.  Eager torch compiles nothing; on the card this
        is the first touch of the allocator, the kernel libraries and
        the kernels' per-stream scratch (``kernels._build.scratch``).
        Covers the default-params lanes (``params`` here must match what
        clients will send)."""

        def warm(send):
            v = self.stream.acquire()
            try:
                send({"op": "warmup", "stamp": v.stamp, "kinds": list(kinds),
                      "params": params})
                self._warm_body(v, kinds, params)
            finally:
                self.stream.release(v)

        self._on_lane(warm)
        self.mark_warm()

    def _warm_body(self, v, kinds, params) -> None:
        """``warmup``'s ladder on the held version ``v`` (every rank runs it)."""
        pkey = params_key(params)
        sizes: List[int] = []
        b = 1
        while b < self.max_batch:
            sizes.append(b)
            b <<= 1
        sizes.append(L.next_pow2(self.max_batch))
        eng = self.stream._engine_for(v, self.backend)
        n = eng.n
        for kind in kinds:
            ladder = [1] if kind == "cc" else sizes
            for size in ladder:
                srcs = [i % max(n, 1) for i in range(size)]
                tickets = [
                    QueryTicket(
                        "_warmup", kind,
                        None if kind == "cc" else srcs[i],
                        params, deadline=time.perf_counter() + 60.0,
                    )
                    for i in range(size)
                ]
                L.execute_batch(eng, kind, tickets, dict(params))
                key = L.trace_key(
                    kind, eng, L.dispatch_pow2(kind, tickets), pkey
                )
                if key is not None:
                    with self._lock:
                        self._kind_metrics[kind].record_trace_key(
                            key, warm=False
                        )
        if self._carry and n:
            self._warm_promotion(eng, kinds)

    def _warm_promotion(self, eng, kinds) -> None:
        """Run the carry-forward path once: promotion runs the
        incremental paths (warm-seeded ``sssp_batch_from``,
        depth→parents, the dense shortest-path-tree pass) the moment
        the first publish lands, and a first touch there stalls the
        promotion thread exactly while the hot entries sit stale on the
        old version.  Results are discarded; a self-loop insert is a
        no-op delta, so every call converges at once."""
        from ...core.traversal import algorithms as talg

        d = Delta(ins=np.asarray([[0, 0]], np.int64))
        sizes: List[int] = [1]
        while sizes[-1] * 2 <= PROMOTE_BATCH:
            sizes.append(sizes[-1] * 2)
        for b in sizes:
            srcs = [0] * b
            if "bfs" in kinds:
                parents, depths = talg.bfs_multi(eng, srcs)
                talg.incremental_bfs(eng, srcs, parents, depths, d)
            if "sssp" in kinds:
                dist = talg.sssp_multi(eng, srcs)
                if b == 1:  # per-lane host loop: shape is B-independent
                    tree = talg.shortest_path_parents(eng, dist, srcs)
                else:
                    tree = np.repeat(tree[:1], b, axis=0)
                talg.incremental_sssp(eng, srcs, dist, tree, d)
        if "cc" in kinds:
            labels = talg.connected_components(eng)
            talg.incremental_connected_components(eng, labels, d)
        if "pagerank" in kinds:
            reset = np.full((1, eng.n), 1.0 / max(eng.n, 1))
            pr = talg.pagerank_multi(eng, resets=reset)
            # the tol path is the only promotion variant with its own
            # call (fixed-iters promotion recomputes on the ladder)
            talg.pagerank_multi(eng, resets=reset, init=pr,
                                tol=1e-6, max_iters=4)

    def mark_warm(self) -> None:
        """Flip the steady-state flag: every trace key first seen after
        this counts as a retrace."""
        with self._lock:
            self._warm = True

    def stats(self) -> dict:
        with self._lock:
            return {
                "running": self._running,
                "warm": self._warm,
                "backend": self.backend,
                "max_batch": self.max_batch,
                "publishes": self._publishes,
                "version_stamp": self.stream.vg.current_stamp,
                "live_versions": self.stream.vg.live_versions(),
                "sessions_open": len(self._sessions),
                "lanes": {
                    k: m.snapshot() for k, m in self._kind_metrics.items()
                },
                "tenants": self._admission.snapshot(),
                "admission": {
                    "backlog": self._admission.backlog_depth(),
                    "in_flight": self._admission.in_flight_total,
                    "max_inflight_total": self._admission.max_inflight_total,
                    "active_flushes": self._active_flushes,
                    "work_conserving": self.work_conserving,
                },
                "updates": self.updates.stats(),
                "cache": None if self._cache is None else dict(
                    self._cache.snapshot(),
                    carry_forward=self._carry,
                    carry_limit=self._carry_limit,
                    fastpath=self._fastpath,
                    anchor_stamp=(
                        None if self._anchor is None else self._anchor.stamp
                    ),
                    promote_errors=self._promote_errors,
                    promote_error=self._promote_error,
                ),
                # the port's traversal.TRACES: 0, eager torch traces nothing
                "jit_traces": TRACES.count,
                "ranks": self._ranks_stats(),
            }

    def _ranks_stats(self) -> Optional[dict]:
        """Under ranks: the world, the op count, and on rank 0 the lane's
        busy seconds (all, and [count, seconds] by op) and the median
        microseconds of a descriptor's broadcast."""
        if self._world == 1:
            return None
        out = {"rank": self._rank, "world": self._world, "ops": len(self.op_log),
               "lane_error": None if self._lane_error is None else repr(self._lane_error)}
        if self._lane is not None:
            bus = sorted(self._lane.broadcast_us)
            by_op = {k: list(v) for k, v in self._lane.op_s.items()}
            out.update(op_s=float(sum(v[1] for v in by_op.values())), op_s_by_op=by_op,
                       broadcasts=len(bus), broadcast_us_p50=bus[len(bus) // 2] if bus else None)
        return out


class _LaneSubscription:
    """A ``Subscription`` on rank 0 of a service across ranks, whose open,
    ``refresh()`` and ``close()`` each run as one op of the collective
    lane (every rank keeps its own copy of the standing result)."""

    def __init__(self, service: GraphQueryService, kind: str, sources, params: dict):
        with service._lock:
            service._subscriptions += 1
            self.id = service._subscriptions
        self._svc = service
        srcs = None if sources is None else [int(s) for s in
                                             np.asarray(sources, np.int64).reshape(-1)]

        def open_(send):
            desc = {"op": "subscribe", "id": self.id, "kind": kind, "sources": srcs,
                    "params": dict(params)}
            send(desc)
            self._sub = service.stream.subscribe(kind, sources=srcs, backend=service.backend,
                                                 **params)
            desc["stamp"] = self._sub.stamp

        service._lane.run(open_)

    def _op(self, op: str, fn):
        def run(send):
            desc = {"op": op, "id": self.id}
            send(desc)
            out = fn()
            desc["stamp"] = self._sub.stamp
            return out

        return self._svc._lane.run(run)

    def refresh(self):
        return self._op("refresh", self._sub.refresh)

    def close(self) -> None:
        if not self._sub._closed:
            self._op("unsubscribe", self._sub.close)

    def __getattr__(self, name):  # kind, stamp, value, n_full, n_incremental
        return getattr(self._sub, name)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()
