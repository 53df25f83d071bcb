"""Snapshot-pinned sessions: strict serializability as an API.

Port copy of ``repro/serve/graph/sessions.py`` (plain Python).

The stream's versioned reads already guarantee each individual query a
consistent snapshot; a ``Session`` extends that to a SEQUENCE of reads.
Opening the session acquires (refcounts) the version current at open
time; every query submitted through it is routed to session-pinned
lanes and served against that exact version no matter how many
publishes land in between — so a multi-query read (e.g. bfs then sssp
then pagerank over "the same graph") is strictly serializable at the
open instant.  ``close()`` waits for in-flight session queries and
releases the reference, letting the version (and its cached engines
and cached RESULTS — the result cache stores payloads on the version
itself) be reclaimed; the ref-leak tests pin that 1k open/close cycles
under a live writer leave zero extra live versions.

The result cache composes with pinning for free: cached answers live
on ``Version.cache``, and ``service.submit`` looks them up against the
session's OWN pinned version — so a session hit can only ever return a
result computed on its snapshot, never a newer version's (pinned by
test), while repeated identical session queries hit without a dispatch.
"""
from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from .request import QueryTicket


class Session:
    """A pinned read handle; use as a context manager:

        with service.session(tenant="alice") as s:
            parents = s.query("bfs", source=0).result()
            dist = s.query("sssp", source=0).result()
        # both answers reflect the SAME version, s.stamp
    """

    def __init__(self, service, tenant: str):
        self._service = service
        self.tenant = tenant
        self._v = service.stream.acquire()
        self._lock = threading.Lock()
        self._pending = 0
        self._idle = threading.Condition(self._lock)
        self._closed = False

    @property
    def stamp(self) -> int:
        """The version stamp every query in this session reads."""
        return self._v.stamp

    @property
    def version(self):
        """The held version (service internals dispatch engines off it)."""
        return self._v

    @property
    def closed(self) -> bool:
        return self._closed

    def query(
        self,
        kind: str,
        source: Optional[int] = None,
        deadline_s: Optional[float] = None,
        **params: Any,
    ) -> QueryTicket:
        """Submit a query pinned to this session's version.  Same
        admission path as ``service.submit`` (the session does not jump
        the tenant's queue); only the serving version differs."""
        with self._lock:
            if self._closed:
                raise RuntimeError("session is closed")
            self._pending += 1
        try:
            ticket = self._service.submit(
                kind,
                source=source,
                tenant=self.tenant,
                deadline_s=deadline_s,
                session=self,
                **params,
            )
        except BaseException:
            with self._lock:
                self._pending -= 1
                self._idle.notify_all()
            raise
        return ticket

    # called by the service when a session ticket completes or fails
    def _query_done(self, ticket: QueryTicket) -> None:
        with self._lock:
            self._pending -= 1
            self._idle.notify_all()

    def close(self, timeout: Optional[float] = 30.0) -> None:
        """Wait out in-flight session queries, then release the pinned
        version.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            deadline = None if timeout is None else timeout
            if not self._idle.wait_for(lambda: self._pending == 0, timeout=deadline):
                raise TimeoutError(
                    f"session for tenant {self.tenant!r} still has "
                    f"{self._pending} queries in flight after {timeout}s"
                )
            self._closed = True
        self._service.stream.release(self._v)
        self._service._forget_session(self)

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __repr__(self):
        state = "closed" if self._closed else f"stamp={self.stamp}"
        return f"Session(tenant={self.tenant!r}, {state})"
