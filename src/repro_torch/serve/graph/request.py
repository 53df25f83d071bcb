"""Request plumbing for the graph-query service.

Port copy of ``repro/serve/graph/request.py`` (plain Python).

A ``QueryTicket`` is both the internal request record (timestamps the
admission / flush pipeline stamps as it moves through) and the handle
the client blocks on.  Results are host numpy arrays: one row of the
lane's batched answer (bfs parents / sssp distances / pagerank scores),
or the shared whole-graph array for global kinds (cc).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional, Tuple

# lane kinds the service batches (DESIGN.md §13):
#   bfs      source required  -> int64[n] parent row
#   sssp     source required  -> float64[n] distance row
#   pagerank source optional  -> float[n] scores (one-hot personalization
#            at ``source``; None = the global uniform reset row)
#   cc       no source        -> int64[n] component labels (global; every
#            request in the flush shares one computation)
KINDS = ("bfs", "sssp", "pagerank", "cc")
SOURCE_REQUIRED = ("bfs", "sssp")


def params_key(params: Dict[str, Any]) -> Tuple:
    """Hashable lane-splitting key: requests batch together only when
    their extra algorithm parameters agree (mixing e.g. two dampings in
    one pagerank flush would silently answer one of them wrong)."""
    return tuple(sorted(params.items()))


class QueryTicket:
    """One admitted query: the client-facing future plus the service's
    internal pipeline record.

    Lifecycle timestamps (``time.perf_counter`` seconds) are stamped by
    the pipeline: ``t_submit`` at submission, ``t_flush`` when its lane
    batch left for the executor, ``t_done`` at completion.  ``deadline``
    is the absolute SLO instant; ``deadline_missed`` is judged at
    completion time.  ``batch_size`` records how many requests rode the
    flush that served this ticket (the coalescing the bench reports).
    """

    __slots__ = (
        "tenant", "kind", "source", "params", "pkey", "session",
        "deadline", "t_submit", "t_flush", "t_done", "batch_size",
        "cached", "fastpath", "_event", "_result", "_error", "_held",
    )

    def __init__(
        self,
        tenant: str,
        kind: str,
        source: Optional[int],
        params: Dict[str, Any],
        deadline: float,
        session=None,
    ):
        if kind not in KINDS:
            raise ValueError(f"unknown query kind {kind!r}; one of {KINDS}")
        if source is None and kind in SOURCE_REQUIRED:
            raise ValueError(f"{kind!r} queries need a source vertex")
        self.tenant = tenant
        self.kind = kind
        self.source = None if source is None else int(source)
        self.params = params
        self.pkey = params_key(params)
        self.session = session
        self.deadline = deadline
        self.t_submit = time.perf_counter()
        self.t_flush: Optional[float] = None
        self.t_done: Optional[float] = None
        self.batch_size: Optional[int] = None
        self.cached = False    # served from the result cache (batch_size 0)
        self.fastpath = False  # served at submit time, no lane/executor hop
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self._held = False

    # -- service side -------------------------------------------------------
    def _hold(self) -> None:
        """Keep the answer from the client until ``_release``: the service
        frees the ticket's admission slot first, so no client sees its
        answer while the slot still counts in flight."""
        self._held = True

    def _release(self) -> None:
        self._held = False
        if self.t_done is not None:
            self._event.set()

    def _complete(self, result) -> None:
        self.t_done = time.perf_counter()
        self._result = result
        if not self._held:
            self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self.t_done = time.perf_counter()
        self._error = exc
        if not self._held:
            self._event.set()

    # -- client side --------------------------------------------------------
    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        """Block for the answer (re-raises a service-side failure)."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"{self.kind} query for tenant {self.tenant!r} not served "
                f"within {timeout}s"
            )
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_submit

    @property
    def deadline_missed(self) -> Optional[bool]:
        """None until completed; then whether the answer landed past the
        SLO instant."""
        return None if self.t_done is None else self.t_done > self.deadline

    def __repr__(self):
        state = "done" if self.done() else "pending"
        return (
            f"QueryTicket({self.kind}, tenant={self.tenant!r}, "
            f"source={self.source}, {state})"
        )
