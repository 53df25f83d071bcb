"""The collective lane: one ``GraphQueryService`` across ``torch.distributed`` ranks.

This module has no counterpart in the reference.  JAX is single-controller:
one process drives every device of the mesh, so the reference's writer,
dispatcher, executor and promotion threads call its sharded engine from
any thread in any order.  The port is multi-controller
(``core/streaming.py``): each rank is a process of its own that must make
the same collective calls in the same order, and a service whose threads
reach the engines in an order set by timing would leave the ranks
waiting on different collectives.

So under a process group of more than one rank, every call of rank 0's
service that reaches a collective runs as one *op* on one thread, the
lane's, in one order: a publish, a flush, a fast-path query, a promotion
pass, warmup, a subscription's open, refresh or close.  Rank 0 decides
everything that is its alone first (admission, tenancy, deadlines, the
result cache and its hits, sessions, batching), then broadcasts the op's
descriptor on the control group (``launch.mesh.control_group``: the op's
kind, the stamp of the version it serves, its sources and params, or the
update rows it publishes), then runs the op; each follower rank receives
the descriptor and runs the same op on its own rows.  Every descriptor
also names the stamps rank 0 still holds (``live``: a follower releases
the rest) and the result-cache entries rank 0 evicted since the last one
(``evict``: a follower's copy of the cache drops them, so both copies
hold the same entries and a promotion starts from the same values on
every rank).  After each op every rank joins one scalar all-reduce on
the control group (``ack_op``).  When idle the lane sends a ``release``
op as soon as rank 0 lets a version go, and a ``keepalive`` op every
``KEEPALIVE_S``, so a follower's wait never runs into the control
group's timeout.

A fault after a broadcast, on any rank, fails that op on rank 0 (its
tickets fail) and stops the lane: every later op fails at once, and
``GraphQueryService`` stops taking requests.  A follower whose op raises
leaves its loop with the error, and its process is expected to end (a
closed connection ends rank 0's collectives at once); a rank that dies
ends the others' waits with an error within ``CONTROL_TIMEOUT_S``.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ...launch import mesh as mesh_lib

_STOP = object()
_TICK_S = 0.02  # how often an idle lane looks for released versions


def lane_world(stream, backend: str) -> Tuple[int, int]:
    """(rank, world size) of the lane that serves ``stream`` with
    ``backend``: the stream's own ``PoolMesh`` when its sharded mirror is
    split across the ranks of a process group of more than one rank,
    which must then be served by the sharded backend; else (0, 1), a
    service of this rank's own (``backend="sharded"`` then raises under
    such a group: its engines would run collectives that no other rank
    joins)."""
    import torch.distributed as dist

    mesh = getattr(stream, "_mesh", None)
    if mesh is not None and mesh.distributed and mesh.size > 1:
        if backend != "sharded":
            raise ValueError(f"a stream sharded across {mesh.size} ranks is served with "
                             f"backend='sharded', not {backend!r}")
        return mesh.rank, mesh.size
    if (backend == "sharded" and dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        raise ValueError(f"backend='sharded' across {dist.get_world_size()} ranks needs a "
                         "mirror='sharded' stream whose rows the ranks share")
    return 0, 1


class LaneFault(RuntimeError):
    """An op failed after its broadcast: the ranks may no longer agree, so
    the lane (and the service on it) is stopped."""


class _Op:
    __slots__ = ("fn", "done", "result", "error")

    def __init__(self, fn):
        self.fn = fn
        self.done = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class CollectiveLane:
    """Rank 0's lane: ``run(fn)`` queues ``fn(send)`` for the lane thread
    and waits for it.  ``fn`` decides what is rank 0's alone, then calls
    ``send(desc)`` once before its first collective (or never, when the
    op needs none: a batch the cache served whole), and returns its
    result.  ``live()`` gives the stamps rank 0 holds and ``extras()``
    the other fields every descriptor carries; ``stamp_of(desc)`` the
    stamp an op logs in ``log``, ``(op, stamp)`` per op sent, as every
    follower logs it.  ``broadcast_us``: each descriptor's broadcast;
    ``op_s``: op -> [count, seconds] on the lane thread, broadcast and ack
    included."""

    def __init__(self, live: Callable[[], List[int]], extras: Callable[[], dict],
                 stamp_of: Callable[[dict], int], on_fault: Callable[[BaseException], None],
                 log: List[Tuple[str, int]]):
        self._live = live
        self._extras = extras
        self._stamp_of = stamp_of
        self._on_fault = on_fault
        self._q: "queue.Queue" = queue.Queue()
        self._thread: Optional[threading.Thread] = None
        self.fault: Optional[BaseException] = None
        self.log = log
        self.broadcast_us: List[float] = []
        self.op_s: Dict[str, List[float]] = {}
        self._live_sent: frozenset = frozenset()
        self._last_send = time.perf_counter()

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, name="graph-serve-lane",
                                            daemon=True)
            self._thread.start()

    def run(self, fn: Callable[[Callable[[dict], None]], Any]) -> Any:
        """``fn(send)`` on the lane thread; its result, or its error (a
        ``LaneFault`` once the lane has stopped)."""
        if self.fault is not None:
            raise LaneFault(f"the collective lane stopped: {self.fault!r}") from self.fault
        if self._thread is None:
            raise RuntimeError("the collective lane is not running")
        op = _Op(fn)
        self._q.put(op)
        op.done.wait()
        if op.error is not None:
            raise op.error
        return op.result

    def stop(self, timeout: float = 30.0) -> None:
        """Send ``stop`` to the followers after every queued op, and join."""
        if self._thread is None:
            return
        self._q.put(_STOP)
        self._thread.join(timeout=timeout)
        self._thread = None

    # -- the lane thread -------------------------------------------------------
    def _send(self, desc: dict) -> None:
        live = self._live()
        desc["live"] = live
        desc.update(self._extras())
        self._live_sent = frozenset(live)
        t = time.perf_counter()
        mesh_lib.send_op(desc)
        self._last_send = time.perf_counter()
        self.broadcast_us.append((self._last_send - t) * 1e6)

    def _finish(self, desc: dict) -> None:
        if mesh_lib.ack_op(False):
            raise LaneFault(f"a follower rank failed op {desc['op']!r}")
        self.log.append((desc["op"], self._stamp_of(desc)))

    def _timed(self, op: str, t: float) -> None:
        c = self.op_s.setdefault(op, [0, 0.0])
        c[0] += 1
        c[1] += time.perf_counter() - t

    def _control(self, op: str) -> None:
        t = time.perf_counter()
        desc = {"op": op}
        self._send(desc)
        self._finish(desc)
        self._timed(op, t)

    def _fail(self, exc: BaseException) -> None:
        if self.fault is None:
            self.fault = exc
            self._on_fault(exc)

    def _idle(self) -> None:
        """A ``release`` op when rank 0 let a version go, else a
        ``keepalive`` op when nothing was sent for ``KEEPALIVE_S``."""
        if self.fault is not None:
            return
        try:
            if self._live_sent - frozenset(self._live()):
                self._control("release")
            elif time.perf_counter() - self._last_send > mesh_lib.KEEPALIVE_S:
                self._control("keepalive")
        except Exception as exc:  # noqa: BLE001 - a rank died while idle
            self._fail(exc)

    def _loop(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=_TICK_S)
            except queue.Empty:
                self._idle()
                continue
            if item is _STOP:
                if self.fault is None:
                    try:
                        self._control("stop")
                    except Exception as exc:  # noqa: BLE001 - a rank died
                        self._fail(exc)
                return
            self._run_op(item)
            self._idle()  # a busy lane whose ops send nothing still keeps alive

    def _run_op(self, op: _Op) -> None:
        if self.fault is not None:
            op.error = LaneFault(f"the collective lane stopped: {self.fault!r}")
            op.done.set()
            return
        sent: List[dict] = []

        def send(desc: dict) -> None:
            if sent:
                raise RuntimeError("an op sends one descriptor")
            sent.append(desc)  # a broadcast that fails faults the lane too
            self._send(desc)

        t = time.perf_counter()
        try:
            op.result = op.fn(send)
            if sent:
                self._finish(sent[0])
                self._timed(sent[0]["op"], t)
        except BaseException as exc:  # noqa: BLE001 - surfaces in run()
            op.error = exc
            if sent:
                self._fail(exc)
        op.done.set()


def follow(handle: Callable[[dict], int], log: List[Tuple[str, int]]) -> None:
    """A follower rank's loop: receive each descriptor, run it
    (``handle(desc)`` returns the stamp the op served or published), ack
    it, log ``(op, stamp)``; returns after ``stop``.  An op that raises
    leaves the loop with its error, unacked."""
    while True:
        desc = mesh_lib.recv_op()
        stamp = handle(desc)
        if mesh_lib.ack_op(False):
            raise LaneFault(f"rank 0 failed op {desc['op']!r}")
        log.append((desc["op"], stamp))
        if desc["op"] == "stop":
            return
