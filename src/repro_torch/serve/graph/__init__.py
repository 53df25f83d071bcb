"""Multi-tenant graph-query serving over a live ``AspenStream``.

Counterpart of ``repro/serve/graph``.  Public surface:

  ``GraphQueryService`` — the server: writer thread (batched update
      publishing), weighted-fair admission, deadline-driven per-kind
      query lanes, pow2-padded batched dispatch, ``stats()``.
  ``Session``      — snapshot-pinned handle: strictly-serializable
      multi-query reads against one version.
  ``QueryTicket``  — the per-request future ``submit()`` returns.
  ``QueueFull``    — backpressure signal on a saturated tenant backlog.
  ``ResultCache``  — version-keyed, delta-aware cross-request result
      cache (on by default inside the service; exposed for tests and
      standalone use).

See DESIGN.md §13 for the admission / flush / pinning contracts and
DESIGN.md §14 for the result-cache key / carry-forward contracts.
"""
from .admission import QueueFull
from .request import KINDS, QueryTicket
from .result_cache import ResultCache
from .service import GraphQueryService
from .sessions import Session

__all__ = [
    "GraphQueryService", "Session", "QueryTicket", "QueueFull", "KINDS",
    "ResultCache",
]
