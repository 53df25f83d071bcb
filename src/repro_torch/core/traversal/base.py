"""Backend contract for the unified edgeMap traversal engine.

Counterpart of ``repro/core/traversal/base.py``.  The paper's query side
is Ligra's ``vertexSubset`` / ``edgeMap`` with direction optimization
(paper §2, §5.1).  The SAME algorithm text (BFS / PageRank / CC / SSSP /
BC in ``algorithms.py``) runs on two substrates in this package:

  * ``numpy_backend.NumpyEngine`` — the CPU engine over a
    ``FlatSnapshot`` (per-vertex C-tree refs, paper §5.1), a copy of the
    reference's;
  * ``torch_backend.TorchEngine`` — the device engine over a
    ``FlatGraph`` (CSR over the packed-key pool), where the dense
    (+, x) reduce runs on the hand-written segment-sum kernels and
    sparse frontier expansion is a fixed-budget searchsorted gather.

Backend contract
----------------
An engine exposes ``n``, ``m``, ``degrees``, ``ops`` (an ``ArrayOps``
whose ``xp`` namespace is numpy, or a device-bound torch namespace),
``frontier_from_ids`` / ``frontier_from_dense`` / ``frontier_all``,
``weights`` / ``weighted`` / ``weighted_degrees``,
``edge_map(U, F, C, state, direction_optimize=True, mode="auto")``
(sparse vs dense by the Ligra/Beamer rule |U| + deg(U) > m / 20),
``edge_map_reduce(values)`` and ``edge_map_reduce_batch(values)`` (the
weighted (+, x) semiring, PageRank's whole inner loop), ``vertex_map``
and ``to_host``.  Engines MAY expose the batched traversals ``bfs_batch``,
``bc_batch``, ``sssp_batch``, ``sssp_batch_from`` and
``parents_from_depths``; ``algorithms.py`` dispatches to them through
``getattr`` and otherwise loops per source.

F and C are pure callbacks written against ``ops``:

  C(ops, state, vs)                -> bool mask over vs (target filter)
  F(ops, state, us, vs, ws, valid) -> (state', out_mask)

``ws`` is the per-edge value lane aligned with ``(us, vs)``, or None on
an unweighted graph; ``valid`` masks padding and unselected lanes.  All
state writes go through the masked ``ops.scatter_*`` helpers.

Host syncs: the port's contract
-------------------------------
The reference fuses every traversal loop into one ``lax.while_loop``,
so a whole multi-source traversal costs O(1) host syncs.  Eager PyTorch
has no device-side loop, so the port's batched traversals loop on the
host and pay ONE blocking sync per round: the stop test and the Beamer
direction decision are fetched together in that one read.  A batched
traversal whose deepest lane needs D productive rounds therefore pays
D + 2 syncs (the source round, D rounds, and the round that finds the
frontier empty) — independent of the batch size B — plus one per
``to_host`` result fetch.  ``HOST_SYNCS`` counts them; the port's tests
pin this contract.  ``TRACES`` exists for API parity with the reference
(its serving layer keys retrace accounting on it); eager torch never
traces, so it stays 0 here.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Optional, Tuple

import numpy as np

# Ligra/Beamer direction-optimization threshold: dense when
# |U| + deg(U) > m / DENSE_THRESHOLD_DENOM (paper §5.1).
DENSE_THRESHOLD_DENOM = 20


class Counter:
    """A spy counter tests assert against (FLAT_REBUILDS, HOST_SYNCS).

    Thread-safe: ``bump`` is hit from ``run_concurrent`` reader threads
    (every frontier-size probe), and an unlocked ``count += 1`` is
    a racy read-modify-write that would undercount under concurrency.
    """

    __slots__ = ("count", "_lock")

    def __init__(self):
        self.count = 0
        self._lock = threading.Lock()

    def bump(self) -> None:
        with self._lock:
            self.count += 1


# Counts blocking device->host syncs issued by the traversal layer
# (frontier-size probes, per-round reads of the batched traversals, result fetches); see
# the module docstring for the port's per-round contract.
HOST_SYNCS = Counter()

# Trace counter of the reference's jitted batched traversals; never bumped here
# (eager torch does not trace).
TRACES = Counter()


class ArrayOps:
    """Functional array helpers shared by F/C callbacks.

    ``xp`` is the backend namespace (numpy, or a torch namespace bound to
    the engine's device); the scatter
    helpers take an explicit ``mask`` and never mutate their inputs.
    """

    xp: Any
    int_dtype: Any
    float_dtype: Any

    def set_at(self, arr, idx, vals):  # pragma: no cover - interface
        raise NotImplementedError

    def scatter_max(self, target, idx, vals, mask):  # pragma: no cover
        raise NotImplementedError

    def scatter_min(self, target, idx, vals, mask):  # pragma: no cover
        raise NotImplementedError

    def scatter_add(self, target, idx, vals, mask):  # pragma: no cover
        raise NotImplementedError

    def scatter_or(self, target, idx, mask):  # pragma: no cover
        raise NotImplementedError


class TraversalEngine:
    """Abstract engine; see module docstring for the contract."""

    ops: ArrayOps

    @property
    def n(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    @property
    def m(self) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    @property
    def degrees(self):  # pragma: no cover - interface
        raise NotImplementedError

    @property
    def weights(self) -> Optional[Any]:
        """Per-edge value array (backend layout), or None when the
        underlying graph carries no edge values."""
        return None

    @property
    def weighted(self) -> bool:
        return self.weights is not None

    @property
    def weighted_degrees(self):
        """Sum of out-edge weights per vertex; == ``degrees`` (as float)
        on unweighted graphs, so one weighted algorithm text serves
        both.  Backends with real weights override."""
        return self.degrees.astype(self.ops.float_dtype)

    @property
    def resident_nbytes(self) -> Optional[int]:
        """Device (or host-array) bytes this engine keeps alive per
        snapshot — graph substrate plus derived aux.  The compression
        benchmarks compare raw vs compressed engines through this one
        number; backends that don't track it return None."""
        return None

    def frontier_from_ids(self, ids):  # pragma: no cover - interface
        raise NotImplementedError

    def frontier_from_dense(self, mask):  # pragma: no cover - interface
        raise NotImplementedError

    def frontier_all(self):
        return self.frontier_from_dense(np.ones(self.n, dtype=bool))

    def edge_map(
        self,
        U,
        F: Callable,
        C: Callable,
        state,
        direction_optimize: bool = True,
        mode: str = "auto",
    ) -> Tuple[Any, Any]:  # pragma: no cover - interface
        raise NotImplementedError

    def edge_map_reduce(self, values):  # pragma: no cover - interface
        raise NotImplementedError

    def edge_map_reduce_batch(self, values):
        """(B, n) value rows -> (B, n) reduced rows.  Default: loop the
        scalar reduce per lane (the numpy fallback); backends with a
        batched kernel path override this."""
        xp = self.ops.xp
        return xp.stack([self.edge_map_reduce(v) for v in values])

    def vertex_map(self, U, P: Callable, state):  # pragma: no cover
        raise NotImplementedError

    def to_host(self, x) -> np.ndarray:
        return np.asarray(x)


def dense_threshold(m: int) -> int:
    """The |U| + deg(U) cutoff above which edge_map goes dense."""
    return max(1, m // DENSE_THRESHOLD_DENOM)
