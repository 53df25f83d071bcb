"""Aspen streaming interface (paper §6 + §7.3): updates alongside queries.

Counterpart of ``repro/core/streaming.py``.  ``AspenStream`` is a
VersionedGraph plus the Ligra-style update API.
Updates are functional: each batch produces a new version published
with SET; readers ACQUIRE snapshots and never block.

Dual representation: alongside the host C-tree ``Graph``, every version
carries a device-resident ``FlatGraph`` mirror (with ``compressed=True``
a chunk-compressed ``CompressedPool``, paper §3.2) kept current
incrementally — each edge batch is applied to the tree AND sorted,
deduped and rank-merged into the mirror on the device, then both are
published atomically as ONE version.  ``engine("torch")`` over an
unchanged version is a cache hit (engines are cached on the version),
and a fresh version's engine costs one ``engine_aux`` over the merged
mirror.  ``mirror="sharded"`` keeps a range-sharded ``ShardedGraph``
(``CompressedShardedGraph``) instead, merged shard-locally and served by
``engine("sharded")``; ``mirror=False`` keeps none, and each version's
engine is rebuilt from its tree snapshot.

Under a ``torch.distributed`` process group (``launch.mesh.init_ranks``)
a sharded stream is one process per rank: each rank keeps its own copy
of the host C-tree and applies the same batches in the same order, and
holds its block of the shard rows (``sharded_pool.PoolMesh``), merged
locally; ``engine("sharded")`` and ``query_batch`` then run on every
rank together, their merges as collectives.  That is multi-controller
SPMD, the counterpart of the reference's single controller driving a
device mesh; every rank must call the same methods in the same order.
A service drives its followers by descriptors: rank 0 names each
update batch (``apply_updates``, the edges in the descriptor) and each
version it serves by its stamp, and a follower keeps every version rank
0 still holds (``StampHolds``) until rank 0 names it released.

Incremental queries: every edge publish records its batch as a
``versioning.Delta`` in the version's aux, and ``stream.subscribe(kind,
...)`` returns a ``Subscription`` whose ``refresh()`` advances a
standing result (pagerank / cc / bfs / sssp) across publishes through
the delta-aware warm-start path instead of recomputing.  ``on_publish``
registers listeners the writer calls after each publish (the serving
layer's promotion trigger).
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
from . import sharded_pool as sp
from .versioning import DELTA, Delta, Version, VersionedGraph

MIRROR = "flat"  # aux key of the FlatGraph mirror on a Version
SHARDED_MIRROR = "sharded"  # aux key of the ShardedGraph mirror
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

    def put_many(self, updates, *, block: bool = True,
                 timeout: Optional[float] = None) -> bool:
        """Enqueue rows ``(src, dst[, delete[, weight]])`` all at once, so
        that a drain sees all of them or none (one of at least
        ``len(updates)`` takes them as one batch).  Waits for room for
        the whole batch; returns False (and counts each row rejected)
        when it stays short — at once on ``block=False``, else after
        ``timeout``.  A batch larger than ``maxsize`` raises."""
        rows = [(int(r[0]), int(r[1]), bool(r[2]) if len(r) > 2 else False,
                 None if len(r) < 4 or r[3] is None else float(r[3])) for r in updates]
        with self._cond:
            if self.maxsize is not None:
                if len(rows) > self.maxsize:
                    raise ValueError(f"{len(rows)} updates exceed the queue's "
                                     f"maxsize {self.maxsize}")
                def room() -> bool:
                    return len(self._q) + len(rows) <= self.maxsize

                if not room() and not (block and self._cond.wait_for(room, timeout=timeout)):
                    self._rejected += len(rows)
                    return False
            self._q.extend(rows)
            self._enqueued += len(rows)
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
    return apply_updates(stream, rows, symmetric) if rows else 0


def apply_updates(stream: "AspenStream", rows, symmetric: bool = True) -> int:
    """``drain_updates``' publish of rows already popped, ``(src, dst,
    delete, weight)`` each: a follower rank applies rank 0's rows here, in
    rank 0's order, and publishes the same versions."""
    if not len(rows):
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


class StampHolds:
    """A follower rank's hold on the versions rank 0 holds: every version
    its stream publishes is held here (a publish listener: one drain of
    updates may publish twice, an insert and a delete) until rank 0 names
    it released (``retain``), so a session's pinned version, the
    promotion anchor and a flush's version are all found by stamp when
    rank 0 serves on them."""

    def __init__(self, stream: "AspenStream"):
        self._stream = stream
        self._held: dict = {}
        self.hold_current()
        self._unsubscribe = stream.on_publish(lambda v: self.hold_current())

    def hold_current(self) -> Version[G.Graph]:
        v = self._stream.acquire()
        if v.stamp in self._held:
            self._stream.release(v)
            return self._held[v.stamp]
        self._held[v.stamp] = v
        return v

    def __getitem__(self, stamp: int) -> Version[G.Graph]:
        v = self._held.get(stamp)
        if v is None:
            raise KeyError(f"version {stamp} is not held on this rank "
                           f"(held: {sorted(self._held)})")
        return v

    def __contains__(self, stamp: int) -> bool:
        return stamp in self._held

    def retain(self, live) -> List[int]:
        """Release every held version whose stamp is not in ``live``; their
        stamps."""
        keep = set(live)
        gone = [s for s in self._held if s not in keep]
        for s in gone:
            self._stream.release(self._held.pop(s))
        return gone

    def close(self) -> None:
        self._unsubscribe()
        self.retain(())


class AspenStream:
    def __init__(
        self,
        initial: Optional[G.Graph] = None,
        b: int = 256,
        seed: int = 0x9E3779B9,
        mirror: "bool | str" = True,
        compressed: bool = False,
        device=None,
        n_shards: Optional[int] = None,
    ):
        """Keeps the resident mirror on ``device`` (``None`` = cuda)
        alongside the tree.  ``mirror=True`` (= ``"flat"``) keeps a
        ``FlatGraph``; ``mirror="sharded"`` a range-sharded
        ``ShardedGraph`` of ``n_shards`` rows (default
        ``sharded_pool.default_n_shards()``), updated by the shard-local
        rank-merge and served by ``engine("sharded")``; ``mirror=False``
        keeps no mirror, and each version's engine is rebuilt from its
        tree snapshot (counted in ``FLAT_REBUILDS``).

        ``compressed=True`` keeps the mirror chunk-compressed
        (``flat_graph.CompressedPool`` / ``sharded_pool.
        CompressedShardedPool``, adaptive widths with ``HI_HEADROOM``
        spare hi rows): each edge batch decompresses, rank-merges and
        recompresses, so the resident state is always a few bytes per
        edge, and ``engine()`` serves the matching compressed engine.
        Construction raises ``ValueError`` when the graph spills the
        layout's escape lane."""
        kind = {True: MIRROR, False: None}[mirror] if isinstance(mirror, bool) else mirror
        if kind not in (None, MIRROR, SHARDED_MIRROR):
            raise ValueError(f"mirror must be bool, 'flat' or 'sharded'; got {mirror!r}")
        if compressed and kind is None:
            raise ValueError("compressed=True requires a resident mirror")
        self.device = resolve(device)
        self._mirror_kind = kind
        self._compressed = compressed
        self.spill_heals = 0  # compressed mirrors rebuilt after an update spilled
        self.rebalances = 0  # sharded mirrors redistributed by the capacity policy
        if kind == SHARDED_MIRROR:
            self._n_shards = n_shards if n_shards is not None else sp.default_n_shards()
            self._mesh = mesh = sp.pool_mesh(self._n_shards, self.device)
            # the update steps, built once per stream
            if compressed:
                self._s_insert = sp.make_insert_step_compressed(mesh)
                self._s_delete = sp.make_delete_step_compressed(mesh)
            else:
                self._s_insert = sp.make_insert_step(mesh)
                self._s_delete = sp.make_delete_step(mesh)
        g0 = initial if initial is not None else G.empty(b, seed)
        aux = {kind: self._mirror_from_tree(g0)} if kind else None
        self.vg: VersionedGraph[G.Graph] = VersionedGraph(g0, aux=aux)
        self._wlock = threading.Lock()  # serializes writers (incl. mirror merge)
        self._publish_listeners: List[Callable[[Version[G.Graph]], None]] = []
        self._listener_lock = threading.Lock()

    # -- publish notification ----------------------------------------------
    def on_publish(self, fn: Callable[[Version[G.Graph]], None]) -> Callable[[], None]:
        """Register a publish listener: ``fn(version)`` is called on the
        writer's thread after each version becomes current, outside the
        write lock (so listeners can acquire and query).  Listeners must
        be fast (set an event, bump a counter), never compute; their
        exceptions are swallowed so a broken listener cannot take down
        the writer.  Returns an idempotent unsubscribe callable."""
        with self._listener_lock:
            self._publish_listeners.append(fn)

        def unsubscribe() -> None:
            with self._listener_lock:
                if fn in self._publish_listeners:
                    self._publish_listeners.remove(fn)

        return unsubscribe

    def _notify_publish(self, v: Version[G.Graph]) -> None:
        with self._listener_lock:
            listeners = list(self._publish_listeners)
        for fn in listeners:
            try:
                fn(v)
            except Exception:  # noqa: BLE001 - listener bugs never block the writer
                pass

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
        if self._mirror_kind == SHARDED_MIRROR:
            from .traversal import sharded_graph_of_flat

            sg = sharded_graph_of_flat(flat, self._n_shards, mesh=self._mesh)
            if self._compressed:
                return sp.compress_sharded(sg, hi_headroom=HI_HEADROOM, mesh=self._mesh)
            return sg
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

    def _sharded_insert(self, mirror, edges: np.ndarray, weights: Optional[np.ndarray] = None):
        """Apply an insert batch to the sharded mirror: the device batch
        (sorted, deduped), then the shard-local rank-merge (the batch is
        the only operand every shard receives: O(batch), not O(pool)).

        Capacity policy, from a host read of the per-shard counts per
        batch: when the fullest shard could overflow, the pool is first
        REBALANCED (an O(m) redistribution to equal counts, the LSM
        compaction) at a grown per-shard capacity, and when
        ``should_rebalance`` sees a shard near capacity or the counts
        skewed, at the same capacity.  A weighted batch against an
        unweighted mirror upgrades the pool to unit values.  Under ranks
        the counts are all S rows' (one gather of S ints), every rank
        reaches the same decision from them, and one scalar all-reduce
        checks that it did."""
        if edges.shape[0] == 0:
            return mirror
        pool = mirror.pool
        mesh = self._mesh
        compressed = isinstance(pool, sp.CompressedShardedPool)
        batch = self._device_batch(edges, weights)
        counts = sp.shard_counts(pool, mesh)
        k = int(edges.shape[0])
        n_out = max(mirror.n, int(edges[:, 0].max()) + 1)
        if weights is not None and pool.vals is None:
            pool = pool._replace(vals=torch.ones((pool.rows, pool.cap_per),
                                                 dtype=torch.float32, device=self.device))
        cap_per = pool.cap_per
        grow = int(counts.max()) + k > cap_per
        rebalance = grow or sp.should_rebalance(pool, counts=counts)
        per = -(-int(counts.sum()) // self._n_shards)
        cap = max(cap_per, fct.grown_capacity(per + k)) if grow else None
        sp.assert_same_decision(mesh, rebalance, cap or 0, n_out, k)
        if rebalance:
            self.rebalances += 1
            pool = (sp.rebalance_compressed(pool, mirror.n, cap_per=cap, mesh=mesh) if compressed
                    else sp.rebalance(pool, cap_per=cap, mesh=mesh))
        if compressed:
            return sp.CompressedShardedGraph(
                self._s_insert(pool, batch.data, batch.vals, n=n_out), n_out)
        return sp.ShardedGraph(self._s_insert(pool, batch.data, batch.vals), n_out)

    def _sharded_delete(self, mirror, edges: np.ndarray):
        if edges.shape[0] == 0:
            return mirror
        batch = self._device_batch(edges)
        if isinstance(mirror.pool, sp.CompressedShardedPool):
            return sp.CompressedShardedGraph(
                self._s_delete(mirror.pool, batch.data, n=mirror.n), mirror.n)
        return sp.ShardedGraph(self._s_delete(mirror.pool, batch.data), mirror.n)

    def _apply_insert(self, mirror, g_old, edges, weights=None):
        if self._mirror_kind == SHARDED_MIRROR:
            return self._sharded_insert(mirror, edges, weights)
        return self._mirror_insert(mirror, g_old, edges, weights)

    def _apply_delete(self, mirror, edges):
        if self._mirror_kind == SHARDED_MIRROR:
            return self._sharded_delete(mirror, edges)
        return self._mirror_delete(mirror, edges)

    def _heal_spill(self, m, g2: G.Graph):
        """Compressed-mirror self-heal: an incremental recompression can
        overflow the escape lane or the hi plane, which the update folds
        into the sticky ``spill`` flag.  One flag read per publish catches
        it, and the mirror is rebuilt from the tree BEFORE the spilled
        state can be published: readers never see a mis-decoding mirror."""
        if isinstance(m, fg.CompressedPool):
            spilled = bool(m.dst.spill)
        elif isinstance(m, sp.CompressedShardedGraph):
            # any rank's spill: every rank rebuilds together
            from .traversal.sharded_backend import ShardedOps

            spilled = bool(ShardedOps(self._mesh).pmax(m.pool.dst.spill.any()[None]))
        else:
            return m
        if not spilled:
            return m
        self.spill_heals += 1
        return self._mirror_from_tree(g2)

    def _publish(self, tree_fn, mirror_fn, delta: Optional[Delta] = None) -> Version[G.Graph]:
        """One writer transaction: update tree + mirror from the held
        version, publish both atomically as a single new version, with
        ``delta`` riding the version's aux under ``versioning.DELTA``.  A
        held version without a mirror (published through the raw ``vg``
        writer API) gets one rebuilt from the new tree; a compressed
        mirror that spilled is rebuilt too (``_heal_spill``).  Publish
        listeners run after the write lock is released."""

        def txn(v: Version[G.Graph]):
            g2 = tree_fn(v.graph)
            aux = {} if delta is None else {DELTA: delta}
            kind = self._mirror_kind
            if kind is not None:
                m = v.aux.get(kind)
                m2 = mirror_fn(m, v.graph, g2) if m is not None else self._mirror_from_tree(g2)
                aux[kind] = self._heal_spill(m2, g2)
            return g2, aux

        with self._wlock:
            v = self.vg.update_with_aux(txn)
        self._notify_publish(v)
        return v

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
            lambda m, g_old, g_new: self._apply_insert(m, g_old, edges, weights),
            delta=Delta(ins=edges, ins_w=weights),
        )

    def delete_edges(self, edges: np.ndarray, symmetric: bool = True):
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if symmetric:
            edges = np.concatenate([edges, edges[:, ::-1]])
        return self._publish(
            lambda g: G.delete_edges(g, edges),
            lambda m, g_old, g_new: self._apply_delete(m, edges),
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
        compressed mirror is decompressed on the way out), or, on
        mirror-less and sharded streams, a one-off rebuild from the tree."""
        v = self.acquire()
        try:
            if MIRROR in v.aux:
                m = v.aux[MIRROR]
                return fg.decompress(m) if isinstance(m, fg.CompressedPool) else m
            return self._flat_from_tree(v.graph)
        finally:
            self.release(v)

    def sharded_graph(self):
        """The current version's ShardedGraph: the resident sharded mirror
        (a compressed one is decompressed on the way out), or, on other
        streams, a one-off partition of the flat mirror (or of a rebuild
        from the tree).  Under ranks, this rank's block of rows
        (``sharded_pool.gather_pool`` puts all of them together)."""
        from .traversal import sharded_graph_of_flat

        v = self.acquire()
        try:
            if SHARDED_MIRROR in v.aux:
                m = v.aux[SHARDED_MIRROR]
                return sp.decompress_sharded(m) if isinstance(m, sp.CompressedShardedGraph) else m
            flat = v.aux.get(MIRROR)
            if flat is None:
                flat = self._flat_from_tree(v.graph)
            elif isinstance(flat, fg.CompressedPool):
                flat = fg.decompress(flat)
            return sharded_graph_of_flat(flat)
        finally:
            self.release(v)

    def shard_stats(self) -> Optional[dict]:
        """Occupancy skew of the current sharded mirror and the policy
        outputs derived from it: ``imbalance`` (max / mean shard counts),
        whether the auto-rebalance trigger would fire, and the recommended
        shard count for the current edge total (None on streams without a
        sharded mirror)."""
        v = self.acquire()
        try:
            m = v.aux.get(SHARDED_MIRROR)
            if m is None:
                return None
            pool = m.pool
            counts = sp.shard_counts(pool, self._mesh)
            stats = sp.imbalance_stats(counts)
            stats["n_shards"] = pool.n_shards
            stats["should_rebalance"] = sp.should_rebalance(pool, counts=counts)
            stats["recommended_n_shards"] = sp.recommend_n_shards(int(counts.sum()))
            return stats
        finally:
            self.release(v)

    def engine(self, backend: str = "numpy"):
        """Traversal engine over the current version: ``"numpy"`` -> a
        NumpyEngine over a FlatSnapshot (CPU); ``"torch"`` -> a
        TorchEngine (compressed streams: a CompressedEngine) over the
        version's resident flat mirror; ``"sharded"`` -> a ShardedEngine
        (CompressedShardedEngine) over its sharded mirror.  A stream
        without that mirror rebuilds the engine's substrate from the
        version's tree snapshot on the stream's device.  Engines are
        cached per (version, backend) and die with the version."""
        v = self.acquire()
        try:
            return self._engine_for(v, backend)
        finally:
            self.release(v)

    def _default_backend(self) -> str:
        return "sharded" if self._mirror_kind == SHARDED_MIRROR else "torch"

    def _engine_for(self, v: Version[G.Graph], backend: str):
        """``engine`` for an already-acquired version (subscriptions pin
        their engine to the version they hold, never the current one)."""
        from .traversal import ENGINE_BUILDS, make_engine

        key = ("engine", backend)
        eng = v.cache.get(key)
        if eng is None:
            ENGINE_BUILDS.bump()
            if backend == "torch" and MIRROR in v.aux:
                eng = make_engine(v.aux[MIRROR])
            elif backend == "sharded" and SHARDED_MIRROR in v.aux:
                eng = make_engine(v.aux[SHARDED_MIRROR])
            else:
                eng = make_engine(G.flat_snapshot(v.graph), backend=backend, device=self.device)
            eng = v.cache.setdefault(key, eng)
        return eng

    def query_batch(self, sources=None, kind: str = "bfs", backend: Optional[str] = None, **kw):
        """Serve a coalesced batch of queries against ONE version-pinned
        engine (``_default_backend()``: the sharded engine on a sharded
        stream, else the torch engine, unless ``backend`` says otherwise).

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
        return self._serve_kind(self.engine(backend or self._default_backend()), kind, sources, kw)

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
                    eng = self._engine_for(v, backend or self._default_backend())
                out.append(self._serve_kind(eng, kind, sources, req))
        finally:
            self.release(v)
        return out

    def subscribe(self, kind: str, sources=None, backend: Optional[str] = None,
                  **params) -> "Subscription":
        """Open a live subscription: a handle whose ``refresh()`` keeps the
        result of one standing query (``"pagerank"`` / ``"cc"`` / ``"bfs"``
        / ``"sssp"``) fresh across publishes through the delta-aware
        incremental path (see ``Subscription``)."""
        return Subscription(self, kind, sources=sources, backend=backend, **params)


class Subscription:
    """A standing query kept fresh across publishes.

    The handle holds (acquires) the version its current result was
    computed against, so that version, its delta record and its cached
    engines are collected together once the subscription advances past
    them or closes.  ``refresh()`` compares the held stamp with the
    writer's current one; when behind, it asks ``vg.delta_between`` for
    the composed update record and applies the incremental path over the
    new snapshot:

      pagerank  warm-start power iteration from the previous scores to
                the same ``tol`` fixed point (valid for any change:
                damping < 1 gives a unique fixed point);
      cc        min-label propagation seeded from the delta endpoints
                (exact; deltas with deletions fall back to full);
      bfs/sssp  dirty-subtree revalidation seeded into the warm
                relaxation (exact, see ``algorithms.incremental_bfs`` /
                ``incremental_sssp``).

    A broken delta chain (a hop collected before this subscriber caught
    up, or a version published without a delta record) turns that one
    refresh into a full recompute, never a wrong answer.  ``n_full`` /
    ``n_incremental`` count which path each refresh took.  Thread-safe;
    at most one refresh runs at a time."""

    KINDS = ("pagerank", "cc", "bfs", "sssp")

    def __init__(
        self,
        stream: AspenStream,
        kind: str,
        sources=None,
        backend: Optional[str] = None,
        damping: float = 0.85,
        tol: float = 1e-6,
        max_iters: int = 200,
    ):
        if kind not in self.KINDS:
            raise ValueError(f"unknown subscription kind {kind!r}")
        if kind in ("bfs", "sssp"):
            if sources is None:
                raise ValueError(f"{kind!r} subscriptions need sources")
            self._sources = np.asarray(sources, dtype=np.int64).reshape(-1)
        else:
            self._sources = None
        self._stream = stream
        self.kind = kind
        self._backend = backend
        self._damping, self._tol, self._max_iters = damping, tol, max_iters
        self._lock = threading.Lock()
        self.n_full = 0
        self.n_incremental = 0
        self._closed = False
        self._v = stream.acquire()
        try:
            self._recompute(self._v)
        except BaseException:
            stream.release(self._v)
            raise

    @property
    def stamp(self) -> int:
        """The version stamp the current result reflects."""
        return self._v.stamp

    @property
    def value(self):
        """The current result, as of ``stamp`` (no refresh): pagerank ->
        scores (n,); cc -> labels (n,); bfs -> (parents, depths)
        int64[B, n]; sssp -> distances float64[B, n]."""
        if self.kind == "pagerank":
            return self._scores
        if self.kind == "cc":
            return self._labels
        if self.kind == "bfs":
            return self._parents, self._depths
        return self._dist

    def _engine(self, v: Version[G.Graph]):
        return self._stream._engine_for(v, self._backend or self._stream._default_backend())

    def _recompute(self, v: Version[G.Graph]) -> None:
        from .traversal import algorithms as talg

        eng = self._engine(v)
        if self.kind == "pagerank":
            self._scores = talg.pagerank(
                eng, damping=self._damping, tol=self._tol, max_iters=self._max_iters
            )
        elif self.kind == "cc":
            self._labels = np.asarray(talg.connected_components(eng), np.int64)
        elif self.kind == "bfs":
            parents, depths = talg.bfs_multi(eng, self._sources)
            self._parents = np.asarray(parents, np.int64)
            self._depths = np.asarray(depths, np.int64)
        else:
            self._dist = np.asarray(talg.sssp_multi(eng, self._sources), np.float64)
            # the shortest-path-tree parents are the state the next
            # delta's dirty-subtree computation needs
            self._tree = talg.shortest_path_parents(eng, self._dist, self._sources)
        self.n_full += 1

    def _advance(self, v: Version[G.Graph], delta: Optional[Delta]) -> None:
        from .traversal import algorithms as talg

        if self.kind == "pagerank":
            self._scores = talg.pagerank(
                self._engine(v), damping=self._damping, tol=self._tol,
                max_iters=self._max_iters, init=self._scores,
            )
            self.n_incremental += 1
            return
        if delta is None or (self.kind == "cc" and delta.has_deletions):
            self._recompute(v)
            return
        eng = self._engine(v)
        if self.kind == "cc":
            self._labels = np.asarray(
                talg.incremental_connected_components(eng, self._labels, delta), np.int64
            )
        elif self.kind == "bfs":
            self._parents, self._depths = talg.incremental_bfs(
                eng, self._sources, self._parents, self._depths, delta
            )
        else:
            self._dist = talg.incremental_sssp(eng, self._sources, self._dist, self._tree, delta)
            self._tree = talg.shortest_path_parents(eng, self._dist, self._sources)
        self.n_incremental += 1

    def refresh(self):
        """Bring the result up to the writer's current version (a no-op
        when already fresh) and return it."""
        with self._lock:
            if self._closed:
                raise RuntimeError("subscription is closed")
            cur = self._stream.acquire()
            if cur.stamp == self._v.stamp:
                self._stream.release(cur)
                return self.value
            try:
                self._advance(cur, self._stream.vg.delta_between(self._v, cur))
            except BaseException:
                self._stream.release(cur)
                raise
            old, self._v = self._v, cur
            self._stream.release(old)
            return self.value

    def close(self) -> None:
        """Release the pinned version (idempotent); it and its delta record
        and cached engines become collectible once no other reader holds
        it."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self._stream.release(self._v)

    def __enter__(self) -> "Subscription":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ConcurrentStats(NamedTuple):
    updates_per_sec: float  # directed edges applied / writer-busy s
    mean_update_latency_s: float
    query_latency_concurrent_s: float
    query_latency_isolated_s: float
    n_updates: int
    n_queries: int
    queries_per_sec: float = 0.0  # queries served / reader-busy s
    subscriber_staleness: float = 0.0  # mean versions behind after each refresh


def run_concurrent(
    stream: AspenStream,
    updates: np.ndarray,  # (k, 3): src, dst, is_delete
    query_fn: Callable[[object], object],
    duration_s: float = 5.0,
    batch_size: int = 1,
    symmetric: bool = True,
    engine_backend: Optional[str] = None,
    queries_per_call: int = 1,
    subscription: Optional[Subscription] = None,
) -> ConcurrentStats:
    """Paper §7.3: a writer applies updates one batch at a time while a
    reader repeatedly runs ``query_fn`` against fresh snapshots.

    ``query_fn`` receives a ``FlatSnapshot`` per query by default, the
    stream's cached engine with ``engine_backend`` ("numpy" / "torch" /
    "sharded"), or a live ``Subscription`` with ``subscription`` (the
    incremental serve path: ``query_fn`` typically calls ``refresh()``).
    In subscriber mode the reader also samples *staleness* after each
    call — how many versions the writer has published past the one the
    subscriber serves — reported as their mean, ``subscriber_staleness``.
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
    staleness: List[int] = []

    def _substrate():
        if subscription is not None:
            return subscription
        if engine_backend is not None:
            return stream.engine(engine_backend)
        return stream.flat_snapshot()

    def reader():
        while not stop.is_set():
            sub = _substrate()
            t0 = time.perf_counter()
            query_fn(sub)
            q_lat.append(time.perf_counter() - t0)
            if subscription is not None:
                staleness.append(stream.vg.current_stamp - subscription.stamp)

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
        subscriber_staleness=float(np.mean(staleness)) if staleness else 0.0,
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
