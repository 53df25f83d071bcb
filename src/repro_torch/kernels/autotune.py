"""Launch-tile autotuner for the Hopper kernels: per-(backend, shape-bucket)
winners.

Counterpart of ``repro/kernels/autotune.py``, with the same structure and
names.  The reference tunes its Pallas block shapes; the port tunes the
launch tiles of its CUDA kernels, the parameters the Hopper kernels take:

* the four sorted segment sums (rows 1-6 of the kernel table) take
  ``{"tile": t}``, the slots a block of ``csrc/segment_reduce.cu``'s pass
  covers, t in ``segment_reduce.TILES`` (2048, 4096, 8192; the default
  4096).  The adaptive chunked sums consult under the fixed-width keys,
  as the reference's do;
* the block SpMM (row 11) takes ``{"row_tile": t, "col_tile": t}``, the
  tile R = C of ``csrc/block_spmm.cu``, t in ``csr_spmm.TILES`` (128,
  256; the default 128).

Design (the reference's DESIGN.md §12):

* **Cache key** = (kernel name, backend, sorted shape dims bucketed to
  the next power of two).  The dims are the reference's (``E``/``n`` for
  the raw sums, ``R``/``n`` for the chunked sums, ``n``/``m`` for the
  SpMM); the port's segment-sum keys add ``D``, the message width,
  because the kernel takes a different code path at D = 1, at D % 4 == 0
  and otherwise (``csrc/segment_reduce.cu``'s ``launch``).  The backend
  is the tensor's device type (``"cuda"`` or ``"cpu"``).
* **Process-level memo** — exactly ONE cold consult per key, also
  across threads: one lock holds each consult and each sweep, so a key
  is swept once however many threads ask (``CONSULTS`` counts the cold
  consults).  The graph service launches kernels from several threads
  (``_build.launch_with_scratch``); the lock order is always this lock,
  then the launch lock: a consult runs before its launch, and no code
  takes this lock while it holds the launch lock.
* **On-disk table** — set ``REPRO_TORCH_AUTOTUNE_CACHE=/path/table.json``
  to persist winners across processes (atomic tmp+rename writes, merged
  on load, a corrupt table reads as empty).  Unset, the table is
  process-local and nothing is written.  The variable is the port's own,
  never the reference's, so the two tables never mix.
* **Sweeping** times ``CANDIDATES[kernel]`` and is on only for
  ``"cuda"``, unless ``REPRO_TORCH_AUTOTUNE=1`` forces it (on the CPU the
  wrappers run their plain versions, so a forced sweep there times those:
  a smoke of the machinery).  With sweeping off, a miss returns
  ``DEFAULTS[kernel]``.  Bump ``TABLE_VERSION`` to invalidate a persisted
  table.

Callers pass a ``sweep_fn(params) -> thunk`` factory that runs the kernel
on synthetic inputs of the real shape with explicit parameters (which
skip the consult, so nothing recurses); ``sweep`` times each candidate
after one warm call as the minimum over repeats, each call synchronised,
and records the winner.  Its launches count in ``SWEEP_LAUNCHES``, never
in a kernel's own ``LAUNCHES``.
"""
from __future__ import annotations

import collections
import json
import os
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from . import _build, csr_spmm, segment_reduce

TABLE_VERSION = 1

SEGMENT_SUM_KERNELS = ("segment_sum", "segment_sum_weighted", "segment_sum_chunked",
                       "segment_sum_weighted_chunked")

DEFAULTS: Dict[str, Dict[str, int]] = {
    **{k: {"tile": segment_reduce.TILE} for k in SEGMENT_SUM_KERNELS},
    "spmm": {"row_tile": csr_spmm.TILE, "col_tile": csr_spmm.TILE},
}

# Small grids: each candidate is one template instance built with the
# library, and a sweep times every one.
CANDIDATES: Dict[str, List[Dict[str, int]]] = {
    **{k: [{"tile": t} for t in segment_reduce.TILES] for k in SEGMENT_SUM_KERNELS},
    "spmm": [{"row_tile": t, "col_tile": t} for t in csr_spmm.TILES],
}

_memo: Dict[Tuple, Dict[str, int]] = {}
# cold-consult spy: bumped once per key the first time dispatch asks
CONSULTS: collections.Counter = collections.Counter()
# sweeps per key, their seconds, and each candidate's best seconds
SWEEPS: collections.Counter = collections.Counter()
SWEEP_SECONDS: Dict[Tuple, float] = {}
TIMINGS: Dict[Tuple, List[Tuple[Dict[str, int], float]]] = {}
# launches made by sweeps (kernel counter name -> count)
SWEEP_LAUNCHES: collections.Counter = collections.Counter()
# test hook: when set, overrides CANDIDATES (e.g. pinned single-candidate
# grids for determinism tests)
_candidate_override: Optional[Dict[str, List[Dict[str, int]]]] = None
_lock = threading.RLock()


def _bucket(x: int) -> int:
    """Next power of two >= x (shape bucket)."""
    return 1 << max(0, int(x - 1).bit_length())


def cache_key(kernel: str, backend: str, shape: Dict[str, int]) -> Tuple:
    return (
        TABLE_VERSION,
        kernel,
        backend,
        tuple(sorted((k, _bucket(int(v))) for k, v in shape.items())),
    )


def _key_str(key: Tuple) -> str:
    ver, kernel, backend, dims = key
    dim_s = ",".join(f"{k}={v}" for k, v in dims)
    return f"v{ver}|{kernel}|{backend}|{dim_s}"


def cache_path() -> Optional[str]:
    return os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE") or None


def _load_disk() -> Dict[str, Dict[str, int]]:
    path = cache_path()
    if not path or not os.path.exists(path):
        return {}
    try:
        with open(path) as f:
            table = json.load(f)
        return table if isinstance(table, dict) else {}
    except (OSError, ValueError):
        return {}  # corrupt/partial table == empty table


def _save_disk(key: Tuple, params: Dict[str, int]) -> None:
    path = cache_path()
    if not path:
        return
    table = _load_disk()  # merge-on-load: keep other processes' winners
    table[_key_str(key)] = params
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(table, f, indent=0, sort_keys=True)
        os.replace(tmp, path)  # atomic on POSIX
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _valid(kernel: str, params) -> bool:
    """A table entry names every parameter of the kernel, as integers."""
    return (isinstance(params, dict) and set(params) == set(DEFAULTS[kernel])
            and all(isinstance(v, int) for v in params.values()))


def sweep_enabled(backend: str) -> bool:
    return backend == "cuda" or os.environ.get("REPRO_TORCH_AUTOTUNE") == "1"


def candidates_for(kernel: str) -> List[Dict[str, int]]:
    if _candidate_override is not None and kernel in _candidate_override:
        return _candidate_override[kernel]
    return CANDIDATES[kernel]


def set_candidates(override: Optional[Dict[str, List[Dict[str, int]]]]) -> None:
    """Pin the candidate grids (tests: determinism under a known grid).
    Pass None to restore the built-in grids."""
    global _candidate_override
    _candidate_override = override


def reset() -> None:
    """Drop the process memo, the consult and sweep counters (tests)."""
    with _lock:
        _memo.clear()
        CONSULTS.clear()
        SWEEPS.clear()
        SWEEP_SECONDS.clear()
        TIMINGS.clear()
        SWEEP_LAUNCHES.clear()


def _sync(out) -> None:
    """Wait for a thunk's result: the card's work, when it ran there."""
    if torch.is_tensor(out) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def sweep(
    kernel: str,
    make_thunk: Callable[[Dict[str, int]], Callable[[], object]],
    key: Tuple,
    repeats: int = 5,
) -> Dict[str, int]:
    """Time every candidate and record the winner under ``key``.

    ``make_thunk(params)`` returns a 0-arg callable running the kernel on
    representative inputs; it may raise to veto a candidate.  Timing is
    the minimum over ``repeats`` synchronised calls, after one warm call.
    Launches made here count in ``SWEEP_LAUNCHES``."""
    with _lock, _build.counting_into(SWEEP_LAUNCHES):
        t_start = time.perf_counter()
        best: Optional[Dict[str, int]] = None
        best_t = float("inf")
        timings = []
        for params in candidates_for(kernel):
            try:
                thunk = make_thunk(params)
                _sync(thunk())  # build + warm
                t = float("inf")
                for _ in range(repeats):
                    t0 = time.perf_counter()
                    _sync(thunk())
                    t = min(t, time.perf_counter() - t0)
            except Exception:
                continue  # candidate infeasible for this shape/backend
            timings.append((dict(params), t))
            if t < best_t:
                best, best_t = dict(params), t
        if best is None:
            best = dict(DEFAULTS[kernel])
        _memo[key] = best
        SWEEPS[key] += 1
        SWEEP_SECONDS[key] = SWEEP_SECONDS.get(key, 0.0) + time.perf_counter() - t_start
        TIMINGS[key] = timings
        _save_disk(key, best)
        return best


def get_params(
    kernel: str,
    shape: Dict[str, int],
    sweep_fn: Optional[Callable[[Dict[str, int]], Callable[[], object]]] = None,
    backend: Optional[str] = None,
) -> Dict[str, int]:
    """The dispatch entry point: winner for (kernel, backend, bucket).

    Order: process memo -> on-disk table -> sweep (if enabled and a
    ``sweep_fn`` is given) -> ``DEFAULTS``.  Exactly one cold consult per
    key, across threads; everything after is a memo hit.  ``backend``
    defaults to ``"cuda"`` when a card is present, else ``"cpu"``."""
    backend = backend or ("cuda" if torch.cuda.is_available() else "cpu")
    key = cache_key(kernel, backend, shape)
    hit = _memo.get(key)
    if hit is not None:
        return hit
    with _lock:
        hit = _memo.get(key)
        if hit is not None:
            return hit  # another thread consulted while this one waited
        CONSULTS[key] += 1
        params = _load_disk().get(_key_str(key))
        if not _valid(kernel, params):
            params = None
        if params is None and sweep_fn is not None and sweep_enabled(backend):
            return sweep(kernel, sweep_fn, key)
        if params is None:
            params = dict(DEFAULTS[kernel])
        _memo[key] = params
        return params
