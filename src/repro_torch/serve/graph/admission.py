"""Tenant admission: weighted fair queuing with in-flight caps.

Port copy of ``repro/serve/graph/admission.py`` (plain Python).

The admission queue sits between ``submit()`` and the query lanes.
Each tenant owns a FIFO backlog; the dispatcher drains backlogs into
lanes by *stride scheduling* — tenant ``t`` carries a virtual pass
``t.vpass`` advanced by ``1 / weight`` per admitted request, and every
admission picks the eligible tenant with the smallest pass.  Over any
saturated interval tenant throughput is therefore proportional to
weight (weight 4 admits 4 requests per weight-1 request), without
starving anyone: a tenant that went idle re-enters at the current
minimum pass (never banks credit).

Eligibility enforces the caps: a tenant with ``in_flight`` (admitted
but not completed) at its ``max_inflight`` — or the service at its
global cap — stays backlogged until completions free slots.  Backlogs
are bounded too: past ``max_backlog`` the submit is REJECTED
(``QueueFull``), the service's explicit backpressure surface.

NOT thread-safe by itself: every method is called under the service's
dispatch lock (single-writer discipline, like the version list).
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional

from .metrics import TenantMetrics
from .request import QueryTicket


class QueueFull(RuntimeError):
    """Submission rejected: the tenant's backlog is at capacity."""


class Tenant:
    __slots__ = ("name", "weight", "max_inflight", "vpass", "backlog",
                 "in_flight", "metrics")

    def __init__(self, name: str, weight: float, max_inflight: int):
        if weight <= 0:
            raise ValueError(f"tenant weight must be positive; got {weight}")
        self.name = name
        self.weight = float(weight)
        self.max_inflight = int(max_inflight)
        self.vpass = 0.0
        self.backlog: Deque[QueryTicket] = deque()
        self.in_flight = 0
        self.metrics = TenantMetrics()


class AdmissionQueue:
    def __init__(
        self,
        weights: Optional[Dict[str, float]] = None,
        default_weight: float = 1.0,
        max_inflight_per_tenant: int = 64,
        max_inflight_total: int = 256,
        max_backlog: int = 8192,
    ):
        self._tenants: Dict[str, Tenant] = {}
        self._default_weight = default_weight
        self._max_inflight_per_tenant = max_inflight_per_tenant
        self.max_inflight_total = max_inflight_total
        self.max_backlog = max_backlog
        self.in_flight_total = 0
        for name, w in (weights or {}).items():
            self.tenant(name, weight=w)

    def tenant(self, name: str, weight: Optional[float] = None) -> Tenant:
        """Get-or-create; ``weight`` only applies at creation (redefining
        a live tenant's weight mid-flight would skew in-progress
        accounting — create tenants up front for custom weights)."""
        t = self._tenants.get(name)
        if t is None:
            t = Tenant(
                name,
                self._default_weight if weight is None else weight,
                self._max_inflight_per_tenant,
            )
            # a fresh tenant starts at the current minimum pass so it
            # competes fairly from now on instead of replaying history
            live = [x.vpass for x in self._tenants.values()]
            t.vpass = min(live) if live else 0.0
            self._tenants[name] = t
        return t

    # -- submit side --------------------------------------------------------
    def submit(self, ticket: QueryTicket) -> None:
        t = self.tenant(ticket.tenant)
        t.metrics.submitted += 1
        if len(t.backlog) >= self.max_backlog:
            t.metrics.rejected += 1
            raise QueueFull(
                f"tenant {t.name!r} backlog at capacity ({self.max_backlog})"
            )
        t.backlog.append(ticket)

    # -- dispatcher side ----------------------------------------------------
    def _eligible(self) -> List[Tenant]:
        return [
            t for t in self._tenants.values()
            if t.backlog and t.in_flight < t.max_inflight
        ]

    def admit(self, max_n: Optional[int] = None) -> List[QueryTicket]:
        """Stride-scheduled admission: repeatedly pop one request from
        the smallest-pass eligible tenant until caps bind (or ``max_n``
        admitted).  Returns the admitted tickets in admission order."""
        out: List[QueryTicket] = []
        while max_n is None or len(out) < max_n:
            if self.in_flight_total >= self.max_inflight_total:
                break
            elig = self._eligible()
            if not elig:
                break
            t = min(elig, key=lambda x: (x.vpass, x.name))
            out.append(t.backlog.popleft())
            t.vpass += 1.0 / t.weight
            t.in_flight += 1
            t.metrics.admitted += 1
            self.in_flight_total += 1
        return out

    def complete(self, ticket: QueryTicket) -> None:
        t = self._tenants[ticket.tenant]
        t.in_flight -= 1
        t.metrics.completed += 1
        self.in_flight_total -= 1

    # -- introspection ------------------------------------------------------
    def backlog_depth(self) -> int:
        return sum(len(t.backlog) for t in self._tenants.values())

    def snapshot(self) -> dict:
        return {
            name: t.metrics.snapshot(
                weight=t.weight, in_flight=t.in_flight, backlog=len(t.backlog)
            )
            for name, t in sorted(self._tenants.items())
        }
