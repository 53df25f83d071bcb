"""Aspen streaming interface (paper §6 + §7.3): updates alongside queries.

Counterpart of ``repro/core/streaming.py`` (lines 64-818 and 1013-1155):
the flat-mirror path.  ``AspenStream`` is a VersionedGraph plus the
Ligra-style update API.  Updates are functional: each batch produces a
new version published with SET; readers ACQUIRE snapshots and never
block.

Dual representation: alongside the host C-tree ``Graph``, every version
carries a device-resident ``FlatGraph`` mirror (with ``compressed=True``
a chunk-compressed ``CompressedPool``, paper §3.2) kept current
incrementally — each edge batch is applied to the tree AND sorted,
deduped and rank-merged into the mirror on the device, then both are
published atomically as ONE version.  ``engine("torch")`` over an
unchanged version is a cache hit (engines are cached on the version),
and a fresh version's engine costs one ``engine_aux`` over the merged
mirror.  Every edge publish records its batch as a
``versioning.Delta``.

Not ported yet (ROADMAP.md queue 1): ``subscribe`` / ``Subscription``
and the incremental query paths, and the sharded mirror
(``mirror="sharded"``, which raises ``NotImplementedError``).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .._device import resolve
from . import flat_ctree as fct
from . import flat_graph as fg
from . import graph as G
from .versioning import DELTA, Delta, Version, VersionedGraph

MIRROR = "flat"  # aux key of the FlatGraph mirror on a Version
# hi-plane slack for adaptive compressed mirrors: fraction of chunk rows
# reserved beyond the exact wide-chunk count at each rebuild, so
# recompression absorbs width drift between full rebuilds
HI_HEADROOM = 1 / 16
QUERY_KINDS = ("bfs", "distances", "bc", "sssp", "pagerank")


class UpdateQueue:
    """Bounded thread-safe queue of pending edge updates feeding a writer
    loop.  One entry per update request: ``(src, dst, delete, weight)``.
    Producers ``put`` (blocking while full unless ``block=False``, which
    rejects instead); the single writer drains with ``drain_updates``.
    ``maxsize=None`` makes the queue unbounded."""

    def __init__(self, maxsize: Optional[int] = 65536):
        self.maxsize = maxsize
        self._q: deque = deque()
        self._cond = threading.Condition()
        self._high_water = 0
        self._enqueued = 0
        self._drained = 0
        self._rejected = 0

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)

    def put(
        self,
        src: int,
        dst: int,
        *,
        delete: bool = False,
        weight: Optional[float] = None,
        block: bool = True,
        timeout: Optional[float] = None,
    ) -> bool:
        """Enqueue one update; returns False (and counts a rejection)
        when the queue stays full — at once on ``block=False``, else after
        ``timeout``."""
        with self._cond:
            if self.maxsize is not None:
                if not block and len(self._q) >= self.maxsize:
                    self._rejected += 1
                    return False
                if not self._cond.wait_for(lambda: len(self._q) < self.maxsize, timeout=timeout):
                    self._rejected += 1
                    return False
            self._q.append((int(src), int(dst), bool(delete), weight))
            self._enqueued += 1
            self._high_water = max(self._high_water, len(self._q))
            self._cond.notify_all()
            return True

    def pop_batch(self, k: int) -> list:
        """Dequeue up to ``k`` pending updates in FIFO order (never blocks)."""
        with self._cond:
            out = []
            while self._q and len(out) < k:
                out.append(self._q.popleft())
            if out:
                self._drained += len(out)
                self._cond.notify_all()  # wake producers blocked on full
            return out

    def wait_nonempty(self, timeout: Optional[float] = None) -> bool:
        """Park until at least one update is pending."""
        with self._cond:
            return self._cond.wait_for(lambda: len(self._q) > 0, timeout=timeout)

    def stats(self) -> dict:
        with self._cond:
            return {
                "depth": len(self._q),
                "maxsize": self.maxsize,
                "high_water": self._high_water,
                "enqueued": self._enqueued,
                "drained": self._drained,
                "rejected": self._rejected,
            }


def drain_updates(queue: UpdateQueue, stream: "AspenStream", max_batch: int,
                  symmetric: bool = True) -> int:
    """Drain up to ``max_batch`` pending updates and apply them as (at
    most) one ``insert_edges`` plus one ``delete_edges`` publish; returns
    how many were applied (0 = queue empty).  Inserts go before deletes
    within a drain; weight-less rows in a weighted batch get unit
    weight."""
    rows = queue.pop_batch(max_batch)
    if not rows:
        return 0
    ins = [(s, d, w) for s, d, dl, w in rows if not dl]
    dels = [(s, d) for s, d, dl, w in rows if dl]
    if ins:
        edges = np.asarray([(s, d) for s, d, _ in ins], dtype=np.int64)
        weights = None
        if any(w is not None for _, _, w in ins):
            weights = np.asarray([1.0 if w is None else float(w) for _, _, w in ins], np.float64)
        stream.insert_edges(edges, symmetric=symmetric, weights=weights)
    if dels:
        stream.delete_edges(np.asarray(dels, dtype=np.int64), symmetric=symmetric)
    return len(rows)


class AspenStream:
    def __init__(
        self,
        initial: Optional[G.Graph] = None,
        b: int = 256,
        seed: int = 0x9E3779B9,
        mirror: "bool | str" = True,
        compressed: bool = False,
        device=None,
    ):
        """Keeps the resident mirror on ``device`` (``None`` = cuda)
        alongside the tree; ``mirror`` must be ``True`` / ``"flat"`` (the
        only mirror ported so far).

        ``compressed=True`` keeps the mirror chunk-compressed
        (``flat_graph.CompressedPool``, adaptive widths with
        ``HI_HEADROOM`` spare hi rows): each edge batch decompresses,
        rank-merges and recompresses, so the resident state is always a
        few bytes per edge, and ``engine("torch")`` serves a
        ``CompressedEngine``.  Construction raises ``ValueError`` when
        the graph spills the layout's escape lane (``compress_host``)."""
        if mirror == "sharded":
            raise NotImplementedError(
                "the sharded mirror is not ported yet (ROADMAP.md queue 1 item 12)"
            )
        if mirror not in (True, MIRROR):
            raise ValueError(f"mirror must be True or 'flat'; got {mirror!r}")
        self.device = resolve(device)
        self._compressed = compressed
        self.spill_heals = 0  # compressed mirrors rebuilt after an update spilled
        g0 = initial if initial is not None else G.empty(b, seed)
        self.vg: VersionedGraph[G.Graph] = VersionedGraph(
            g0, aux={MIRROR: self._mirror_from_tree(g0)}
        )
        self._wlock = threading.Lock()  # serializes writers (incl. mirror merge)

    # -- mirror maintenance -------------------------------------------------
    def _flat_from_tree(self, g: G.Graph) -> fg.FlatGraph:
        """Full FlatGraph rebuild (O(m) host): construction and the rare
        vertex-set operations; edge batches take the incremental path."""
        from .traversal import flat_graph_of

        return flat_graph_of(G.flat_snapshot(g), device=self.device)

    def _mirror_from_tree(self, g: G.Graph):
        """Full mirror rebuild in the stream's representation.  On
        compressed streams it is also the spill recovery point:
        ``compress_host`` re-selects widths and re-sizes the hi plane from
        scratch, and raises rather than publish a mis-decoding mirror."""
        flat = self._flat_from_tree(g)
        if self._compressed:
            return fg.compress_host(flat, hi_headroom=HI_HEADROOM)
        return flat

    def _device_batch(self, edges: np.ndarray, weights: Optional[np.ndarray] = None):
        """Pack an edge batch and ship it to the device at a power-of-two
        shape (padded with the pool sentinel, which ``fct.from_device``
        drops); ``weights`` ride along as the batch's value array."""
        keys = (edges[:, 0] << 32) | edges[:, 1]
        cap = fct.grown_capacity(keys.size)
        padded = np.full(cap, fct.SENTINEL64, dtype=np.int64)
        padded[: keys.size] = keys
        dev_keys = torch.from_numpy(padded).to(self.device)
        if weights is None:
            return fct.from_device(dev_keys, cap)
        wpad = np.zeros(cap, dtype=np.float32)
        wpad[: keys.size] = weights
        return fct.from_device(dev_keys, cap, vals=torch.from_numpy(wpad).to(self.device))

    def _mirror_insert(self, mirror, g_old: G.Graph, edges: np.ndarray,
                       weights: Optional[np.ndarray] = None):
        """Apply an insert batch to the mirror on the device: sort/dedup the
        batch, rank-merge (compressed: decompress, merge, recompress).
        Capacity and vertex growth come from host-known counts (the tree's
        edge count, the batch's max source), so no device->host read is
        needed.  A weighted batch against an unweighted mirror upgrades it
        to unit weights first."""
        if edges.shape[0] == 0:
            return mirror
        compressed = isinstance(mirror, fg.CompressedPool)
        if weights is not None and mirror.weights is None:
            mirror = (fg.with_unit_weights_compressed(mirror) if compressed
                      else fg.with_unit_weights(mirror))
        batch = self._device_batch(edges, weights)
        # vertices are created by their first out-edge (matching the tree)
        n_out = max(mirror.n, int(edges[:, 0].max()) + 1)
        need = G.num_edges(g_old) + edges.shape[0]
        cap = max(mirror.edge_capacity, fct.grown_capacity(need))
        n_out = None if n_out == mirror.n else n_out
        if compressed:
            return fg.insert_edges_compressed(mirror, batch, cap, n_out)
        return fg.insert_edges_device(mirror, batch, cap, n_out=n_out)

    def _mirror_delete(self, mirror, edges: np.ndarray):
        if edges.shape[0] == 0:
            return mirror
        if isinstance(mirror, fg.CompressedPool):
            return fg.delete_edges_compressed(mirror, self._device_batch(edges),
                                              mirror.edge_capacity)
        return fg.delete_edges_device(mirror, self._device_batch(edges))

    def _heal_spill(self, m, g2: G.Graph):
        """Compressed-mirror self-heal: an incremental recompression can
        overflow the escape lane or the hi plane, which the update folds
        into the sticky ``spill`` flag.  One flag read per publish catches
        it, and the mirror is rebuilt from the tree BEFORE the spilled
        state can be published: readers never see a mis-decoding mirror."""
        if not isinstance(m, fg.CompressedPool) or not bool(m.dst.spill):
            return m
        self.spill_heals += 1
        return self._mirror_from_tree(g2)

    def _publish(self, tree_fn, mirror_fn, delta: Optional[Delta] = None) -> Version[G.Graph]:
        """One writer transaction: update tree + mirror from the held
        version, publish both atomically as a single new version, with
        ``delta`` riding the version's aux under ``versioning.DELTA``.  A
        held version without a mirror (published through the raw ``vg``
        writer API) gets one rebuilt from the new tree; a compressed
        mirror that spilled is rebuilt too (``_heal_spill``)."""

        def txn(v: Version[G.Graph]):
            g2 = tree_fn(v.graph)
            aux = {} if delta is None else {DELTA: delta}
            m = v.aux.get(MIRROR)
            m2 = mirror_fn(m, v.graph, g2) if m is not None else self._mirror_from_tree(g2)
            aux[MIRROR] = self._heal_spill(m2, g2)
            return g2, aux

        with self._wlock:
            return self.vg.update_with_aux(txn)

    # -- update API (paper Appendix 10.4) ---------------------------------
    def insert_edges(self, edges: np.ndarray, symmetric: bool = True,
                     weights: Optional[np.ndarray] = None):
        """InsertEdges, optionally weighted (one value per batch edge; a
        symmetric insert carries it on both directions).  Inserting an
        existing edge overwrites its weight.  The first weighted batch
        upgrades an unweighted stream (prior edges read as unit weight)."""
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if weights is not None:
            weights = np.asarray(weights, dtype=np.float64).reshape(-1)
            if weights.size != edges.shape[0]:
                raise ValueError("one weight per edge")
        if symmetric:
            edges = np.concatenate([edges, edges[:, ::-1]])
            if weights is not None:
                weights = np.concatenate([weights, weights])
        return self._publish(
            lambda g: G.insert_edges(g, edges, weights=weights),
            lambda m, g_old, g_new: self._mirror_insert(m, g_old, edges, weights),
            delta=Delta(ins=edges, ins_w=weights),
        )

    def delete_edges(self, edges: np.ndarray, symmetric: bool = True):
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if symmetric:
            edges = np.concatenate([edges, edges[:, ::-1]])
        return self._publish(
            lambda g: G.delete_edges(g, edges),
            lambda m, g_old, g_new: self._mirror_delete(m, edges),
            delta=Delta(dels=edges),
        )

    def insert_vertices(self, vs: np.ndarray):
        # vertex-set ops are rare: the mirror takes the rebuild path
        return self._publish(
            lambda g: G.insert_vertices(g, vs),
            lambda m, g_old, g_new: self._mirror_from_tree(g_new),
        )

    def delete_vertices(self, vs: np.ndarray):
        return self._publish(
            lambda g: G.delete_vertices(g, vs),
            lambda m, g_old, g_new: self._mirror_from_tree(g_new),
        )

    # -- read API -----------------------------------------------------------
    def acquire(self):
        return self.vg.acquire()

    def release(self, v):
        return self.vg.release(v)

    def flat_snapshot(self) -> G.FlatSnapshot:
        v = self.acquire()
        try:
            return G.flat_snapshot(v.graph)
        finally:
            self.release(v)

    def flat_graph(self) -> fg.FlatGraph:
        """The current version's FlatGraph: the resident mirror (a
        compressed mirror is decompressed on the way out)."""
        v = self.acquire()
        try:
            m = v.aux[MIRROR]
            return fg.decompress(m) if isinstance(m, fg.CompressedPool) else m
        finally:
            self.release(v)

    def engine(self, backend: str = "numpy"):
        """Traversal engine over the current version: ``"numpy"`` -> a
        NumpyEngine over a FlatSnapshot (CPU); ``"torch"`` -> a
        TorchEngine (compressed streams: a CompressedEngine) over the
        version's resident mirror.  Engines are cached per (version,
        backend) and die with the version."""
        v = self.acquire()
        try:
            return self._engine_for(v, backend)
        finally:
            self.release(v)

    def _engine_for(self, v: Version[G.Graph], backend: str):
        """``engine`` for an already-acquired version."""
        from .traversal import ENGINE_BUILDS, make_engine

        key = ("engine", backend)
        eng = v.cache.get(key)
        if eng is None:
            ENGINE_BUILDS.bump()
            if backend == "torch":
                eng = make_engine(v.aux[MIRROR])
            else:
                eng = make_engine(G.flat_snapshot(v.graph), backend=backend)
            eng = v.cache.setdefault(key, eng)
        return eng

    def query_batch(self, sources=None, kind: str = "bfs", backend: Optional[str] = None, **kw):
        """Serve a coalesced batch of queries against ONE version-pinned
        engine (the torch engine unless ``backend`` says otherwise).

        kinds: ``"bfs"`` -> int64[B, n] parent rows; ``"distances"`` ->
        int64[B, n] hop counts; ``"bc"`` -> float[B, n] dependency scores;
        ``"sssp"`` -> float64[B, n] distances (+inf = unreached);
        ``"pagerank"`` -> float[B, n] scores for the personalization rows
        passed as ``resets`` (``sources`` unused).  Extra kwargs go to the
        traversal-layer ``*_multi``.  Identical sources inside one batch
        compute once and fan back out.  An empty request returns ``[]``
        without touching an engine."""
        if kind not in QUERY_KINDS:
            raise ValueError(f"unknown query kind {kind!r}")
        if self._empty_request(kind, sources, kw):
            return []
        return self._serve_kind(self.engine(backend or "torch"), kind, sources, kw)

    @staticmethod
    def _empty_request(kind: str, sources, kw) -> bool:
        if kind == "pagerank":
            resets = kw.get("resets")
            return resets is not None and np.asarray(resets).shape[0] == 0
        if sources is None:
            return True
        return np.asarray(sources, dtype=np.int64).reshape(-1).size == 0

    @staticmethod
    def _serve_kind(eng, kind: str, sources, kw):
        from .traversal import algorithms as talg

        if kind == "pagerank":
            return talg.pagerank_multi(eng, **kw)
        sources = np.asarray(sources, dtype=np.int64).reshape(-1)
        uniq, inv = np.unique(sources, return_inverse=True)
        if kind == "bfs":
            return talg.bfs_multi(eng, uniq, **kw)[0][inv]
        if kind == "distances":
            return talg.landmark_distances(eng, uniq, **kw)[inv]
        if kind == "bc":
            return talg.bc_multi(eng, uniq, **kw)[inv]
        return talg.sssp_multi(eng, uniq, **kw)[inv]

    def query_multi(self, requests, backend: Optional[str] = None):
        """Serve a MIXED-kind batch against one version: a list of
        ``{"kind": ..., "sources": ..., **kwargs}`` requests answered in
        order against one acquired version and one engine fetch."""
        out = []
        v = self.acquire()
        try:
            eng = None
            for req in requests:
                req = dict(req)
                kind = req.pop("kind", "bfs")
                sources = req.pop("sources", None)
                if kind not in QUERY_KINDS:
                    raise ValueError(f"unknown query kind {kind!r}")
                if self._empty_request(kind, sources, req):
                    out.append([])
                    continue
                if eng is None:
                    eng = self._engine_for(v, backend or "torch")
                out.append(self._serve_kind(eng, kind, sources, req))
        finally:
            self.release(v)
        return out


class ConcurrentStats(NamedTuple):
    updates_per_sec: float  # directed edges applied / writer-busy s
    mean_update_latency_s: float
    query_latency_concurrent_s: float
    query_latency_isolated_s: float
    n_updates: int
    n_queries: int
    queries_per_sec: float = 0.0  # queries served / reader-busy s


def run_concurrent(
    stream: AspenStream,
    updates: np.ndarray,  # (k, 3): src, dst, is_delete
    query_fn: Callable[[object], object],
    duration_s: float = 5.0,
    batch_size: int = 1,
    symmetric: bool = True,
    engine_backend: Optional[str] = None,
    queries_per_call: int = 1,
) -> ConcurrentStats:
    """Paper §7.3: a writer applies updates one batch at a time while a
    reader repeatedly runs ``query_fn`` against fresh snapshots.

    ``query_fn`` receives a ``FlatSnapshot`` per query by default, or the
    stream's cached engine with ``engine_backend`` ("numpy"/"torch").
    ``queries_per_call`` says how many user queries one call serves.  The
    reported throughput counts directed edges actually applied (2x the
    batch only when symmetric)."""
    stop = threading.Event()
    upd_lat: List[float] = []
    n_upd = [0]
    n_directed = [0]
    per_update = 2 if symmetric else 1

    # the writer loop is the same code path a serving writer runs
    pending = UpdateQueue(maxsize=None)
    for row in updates:
        pending.put(int(row[0]), int(row[1]), delete=bool(row[2]), block=False)

    def updater():
        while not stop.is_set():
            t0 = time.perf_counter()
            k = drain_updates(pending, stream, batch_size, symmetric=symmetric)
            if k == 0:
                break
            upd_lat.append(time.perf_counter() - t0)
            n_upd[0] += k
            n_directed[0] += k * per_update

    q_lat: List[float] = []

    def _substrate():
        if engine_backend is not None:
            return stream.engine(engine_backend)
        return stream.flat_snapshot()

    def reader():
        while not stop.is_set():
            sub = _substrate()
            t0 = time.perf_counter()
            query_fn(sub)
            q_lat.append(time.perf_counter() - t0)

    tu = threading.Thread(target=updater)
    tq = threading.Thread(target=reader)
    tu.start()
    tq.start()
    time.sleep(duration_s)
    stop.set()
    tu.join()
    tq.join()

    # isolated query latency on the final version
    sub = _substrate()
    iso: List[float] = []
    for _ in range(max(3, min(10, len(q_lat)))):
        t0 = time.perf_counter()
        query_fn(sub)
        iso.append(time.perf_counter() - t0)

    total_upd_time = sum(upd_lat) if upd_lat else 1e-9
    return ConcurrentStats(
        updates_per_sec=n_directed[0] / total_upd_time,
        mean_update_latency_s=float(np.mean(upd_lat)) if upd_lat else 0.0,
        query_latency_concurrent_s=float(np.mean(q_lat)) if q_lat else 0.0,
        query_latency_isolated_s=float(np.mean(iso)),
        n_updates=n_upd[0],
        n_queries=len(q_lat) * queries_per_call,
        queries_per_sec=len(q_lat) * queries_per_call / max(sum(q_lat), 1e-9),
    )


def make_update_stream(
    edges: np.ndarray, n_updates: int, seed: int = 0, delete_frac: float = 0.1
) -> Tuple[np.ndarray, np.ndarray]:
    """Paper §7.3 methodology: sample updates from the input graph.
    Returns (graph_edges_after_removal, update_stream[k,3]) where 90% of
    the sampled edges are first removed from the graph and re-inserted by
    the stream; 10% stay and get deleted by the stream."""
    rng = np.random.default_rng(seed)
    m = edges.shape[0]
    k = min(n_updates, m)
    pick = rng.choice(m, size=k, replace=False)
    sampled = edges[pick]
    n_ins = int(k * (1 - delete_frac))
    ins, dels = sampled[:n_ins], sampled[n_ins:]
    keep_mask = np.ones(m, dtype=bool)
    keep_mask[pick[:n_ins]] = False  # insertions start absent
    stream = np.concatenate(
        [
            np.concatenate([ins, np.zeros((ins.shape[0], 1), np.int64)], axis=1),
            np.concatenate([dels, np.ones((dels.shape[0], 1), np.int64)], axis=1),
        ]
    )
    rng.shuffle(stream)
    return edges[keep_mask], stream
