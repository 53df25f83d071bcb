"""Graphs as trees of C-trees (paper §5) — the faithful Aspen core.

The vertex-tree is a purely-functional augmented treap (``pam``) mapping
``vertex_id -> edge C-tree``; the augmentation tracks total edge count so
``num_edges`` is O(1).  Batch updates follow §5 exactly: sort the batch,
build a C-tree per touched source, MULTIINSERT into the vertex-tree with
UNION as the value-combiner.

A *flat snapshot* (§5.1) is an array of per-vertex edge-tree references —
O(n) work to build, after which edge access is O(deg(v)) like CSR.

Port copy of ``repro/core/graph.py`` (numpy only), unchanged apart from this note.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np

from . import ctree as ct
from .pam import Node, TreeModule

# vertex-tree: value = edge C-tree; aug = #edges
_VMOD = TreeModule(
    aug_of=lambda k, et: ct.ctree_size(et) if et is not None else 0,
    combine=lambda a, b: a + b,
    zero=0,
)

# weight-tree: purely-functional map packed (src<<32|dst) -> float edge
# value (the PaC-tree "collections carry associated values" side of the
# design, DESIGN.md §8).  It versions with the graph for free — every
# snapshot shares structure with its ancestors — and stays None on
# unweighted graphs (no storage, no maintenance work).
_WMOD = TreeModule()


def _pack_edges(edges: np.ndarray) -> np.ndarray:
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    return (edges[:, 0] << 32) | edges[:, 1]


class Graph(NamedTuple):
    """An immutable graph snapshot (one version).

    ``wtree`` optionally maps packed edge keys to per-edge float values
    (weights); ``None`` means unweighted.  A weighted graph keeps the
    weight map exactly in sync with the edge set: inserts overwrite the
    value of an existing edge, deletes drop it.
    """

    vtree: Node  # treap: vertex id -> CTree of neighbor ids
    b: int = ct.DEFAULT_B
    seed: int = ct.DEFAULT_SEED
    wtree: Node = None  # treap: packed (src<<32|dst) -> float weight


def empty(b: int = ct.DEFAULT_B, seed: int = ct.DEFAULT_SEED) -> Graph:
    return Graph(None, b, seed)


def num_vertices(g: Graph) -> int:
    from .pam import size

    return size(g.vtree)


def num_edges(g: Graph) -> int:
    """O(1) via the vertex-tree augmentation (paper §5)."""
    return _VMOD.aug(g.vtree)


def find_vertex(g: Graph, v: int) -> Optional[ct.CTree]:
    return _VMOD.find(g.vtree, v)


def degree(g: Graph, v: int) -> int:
    et = find_vertex(g, v)
    return ct.ctree_size(et) if et is not None else 0


# ---------------------------------------------------------------------------
# construction & batch updates (paper §5 "Batch Updates")
# ---------------------------------------------------------------------------


def _group_batch(edges: np.ndarray):
    """Sort a (k, 2) batch by (src, dst) and yield (src, dst_array)."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if edges.shape[0] == 0:
        return
    order = np.lexsort((edges[:, 1], edges[:, 0]))
    edges = edges[order]
    srcs, starts = np.unique(edges[:, 0], return_index=True)
    bounds = np.append(starts, edges.shape[0])
    for i, s in enumerate(srcs.tolist()):
        yield int(s), edges[bounds[i] : bounds[i + 1], 1]


def _wtree_insert(g: Graph, edges: np.ndarray, weights: Optional[np.ndarray]) -> Node:
    """New weight-tree after an insert batch: overwrite-on-duplicate
    across batches, first-occurrence-wins within one batch (matching
    the flat pool's dedup).  A weight-less batch against a weighted
    graph gets unit weights."""
    if weights is None and g.wtree is None:
        return None
    keys = _pack_edges(edges)
    if weights is None:
        w = np.ones(keys.size, dtype=np.float64)
    else:
        w = np.asarray(weights, dtype=np.float64).reshape(-1)
        if w.size != keys.size:
            raise ValueError("one weight per edge")
    _, first = np.unique(keys, return_index=True)
    entries = [(int(keys[i]), float(w[i])) for i in first]
    return _WMOD.multi_insert(
        g.wtree, entries, combine_values=lambda old, new: new
    )


def build_graph(
    n: int,
    edges: np.ndarray,
    b: int = ct.DEFAULT_B,
    seed: int = ct.DEFAULT_SEED,
    weights: Optional[np.ndarray] = None,
) -> Graph:
    """BuildGraph: n isolated vertices + a batch of directed edges."""
    per_vertex = {s: d for s, d in _group_batch(edges)}
    entries = []
    for v in range(n):
        dsts = per_vertex.get(v)
        et = ct.build(dsts, b, seed) if dsts is not None else ct.empty(b, seed)
        entries.append((v, et))
    g = Graph(_VMOD.build_sorted(entries), b, seed)
    if weights is None:
        return g
    return g._replace(wtree=_wtree_insert(g, edges, weights))


def insert_edges(g: Graph, edges: np.ndarray, weights: Optional[np.ndarray] = None) -> Graph:
    """InsertEdges: functional batch insert (new snapshot returned).

    Sort batch -> per-source C-trees -> MultiInsert with UNION combiner
    (paper §5).  Vertices not yet present are created.  ``weights``
    attaches one value per batch edge (overwriting the value of an edge
    already present); passing weights to an unweighted graph upgrades
    it — edges inserted before the upgrade read as unit weight.
    """
    updates = [
        (s, ct.build(dsts, g.b, g.seed)) for s, dsts in _group_batch(edges)
    ]
    vt = _VMOD.multi_insert(
        g.vtree,
        updates,
        combine_values=lambda old, new: ct.union(old, new)
        if old is not None
        else new,
    )
    return Graph(vt, g.b, g.seed, _wtree_insert(g, edges, weights))


def delete_edges(g: Graph, edges: np.ndarray) -> Graph:
    """DeleteEdges: functional batch delete via DIFFERENCE (a deleted
    edge drops its weight)."""
    removals = {s: dsts for s, dsts in _group_batch(edges)}
    updates = []
    for s, dsts in removals.items():
        old = _VMOD.find(g.vtree, s)
        if old is None:
            continue
        updates.append((s, ct.multi_delete(old, dsts)))
    vt = _VMOD.multi_insert(g.vtree, updates, combine_values=lambda old, new: new)
    wt = g.wtree
    if wt is not None:
        wt = _WMOD.multi_delete(wt, [int(k) for k in _pack_edges(edges)])
    return Graph(vt, g.b, g.seed, wt)


def insert_vertices(g: Graph, vs: np.ndarray) -> Graph:
    updates = [(int(v), ct.empty(g.b, g.seed)) for v in np.asarray(vs)]
    vt = _VMOD.multi_insert(g.vtree, updates, combine_values=lambda old, new: old)
    return Graph(vt, g.b, g.seed, g.wtree)


def delete_vertices(g: Graph, vs: np.ndarray) -> Graph:
    """Remove vertices (and their out-edges; callers of symmetric graphs
    pass both endpoints' edges to delete_edges first)."""
    vt = _VMOD.multi_delete(g.vtree, [int(v) for v in np.asarray(vs)])
    wt = g.wtree
    if wt is not None:
        # purge weights whose src was removed (dst-side weights were
        # dropped by the delete_edges call symmetric callers issue).
        # Vertex v's packed keys are the contiguous range
        # [v<<32, (v+1)<<32), so each purge is two ordered splits —
        # O(log W) per vertex, not a full weight-tree walk.
        for v in sorted(int(x) for x in np.asarray(vs)):
            lo, hi = v << 32, (v + 1) << 32
            left, _, rest = _WMOD.split(wt, lo)
            _, at_hi, right = _WMOD.split(rest, hi)
            if at_hi is not None:  # hi is the NEXT vertex's first key
                right = _WMOD.join(None, hi, at_hi, right)
            wt = _WMOD.join2(left, right)
    return Graph(vt, g.b, g.seed, wt)


# ---------------------------------------------------------------------------
# flat snapshots (paper §5.1)
# ---------------------------------------------------------------------------


class FlatSnapshot:
    """Array of per-vertex edge-tree refs: O(1) vertex access (§5.1).

    Building is O(n) work / O(log n) depth in the paper (one traversal);
    the functional trees underneath stay shared and immutable, so a flat
    snapshot can be taken concurrently with updates.

    The snapshot caches its degree vector and total directed edge count
    ``m`` on first access: the direction-optimization threshold in the
    traversal engine consults ``m`` every edgeMap call, and the old
    per-query O(n) python degree loop was a measurable constant cost.

    Weighted graphs additionally hand the snapshot their weight-tree:
    ``edge_weights(srcs, dsts)`` answers vectorized per-edge lookups
    from a sorted (keys, values) export materialized LAZILY on first
    use (so unweighted queries — and weighted streams that never run a
    weighted algorithm on this snapshot — stay O(n) to snapshot).
    """

    __slots__ = (
        "edge_trees", "n", "_degrees", "_m", "_engine", "_wtree", "_wexport"
    )

    def __init__(
        self,
        edge_trees: List[Optional[ct.CTree]],
        n: int,
        wtree: Node = None,
    ):
        self.edge_trees = edge_trees
        self.n = n
        self._degrees: Optional[np.ndarray] = None
        self._m: Optional[int] = None
        self._engine = None  # cached traversal NumpyEngine (CSR caches)
        self._wtree = wtree
        self._wexport = None  # lazy (sorted packed keys, float64 values)

    @property
    def weighted(self) -> bool:
        return self._wtree is not None

    def _weight_export(self):
        if self._wexport is None:
            pairs = list(_WMOD.iter_entries(self._wtree))  # in-order: sorted
            keys = np.fromiter((k for k, _ in pairs), np.int64, count=len(pairs))
            vals = np.fromiter((v for _, v in pairs), np.float64, count=len(pairs))
            self._wexport = (keys, vals)
        return self._wexport

    def edge_weights(self, srcs: np.ndarray, dsts: np.ndarray) -> np.ndarray:
        """float64 weight per (src, dst) pair; edges missing from the
        weight map (pre-upgrade inserts) read as unit weight."""
        keys, vals = self._weight_export()
        q = (np.asarray(srcs, np.int64) << 32) | np.asarray(dsts, np.int64)
        if keys.size == 0:
            return np.ones(q.shape, np.float64)
        idx = np.minimum(np.searchsorted(keys, q), keys.size - 1)
        return np.where(keys[idx] == q, vals[idx], 1.0)

    def neighbors(self, v: int) -> np.ndarray:
        et = self.edge_trees[v]
        return ct.to_array(et) if et is not None else np.empty(0, np.int64)

    def degree(self, v: int) -> int:
        et = self.edge_trees[v]
        return ct.ctree_size(et) if et is not None else 0

    @property
    def degrees(self) -> np.ndarray:
        """Cached degree vector (each entry O(1) via the C-tree size
        augmentation; materialized once per snapshot)."""
        if self._degrees is None:
            self._degrees = np.fromiter(
                (self.degree(v) for v in range(self.n)), np.int64, count=self.n
            )
        return self._degrees

    @property
    def m(self) -> int:
        """Total directed edge count (cached degree sum)."""
        if self._m is None:
            self._m = int(self.degrees.sum())
        return self._m


def flat_snapshot(g: Graph) -> FlatSnapshot:
    pairs = list(_VMOD.iter_entries(g.vtree))
    max_v = pairs[-1][0] if pairs else -1
    refs: List[Optional[ct.CTree]] = [None] * (max_v + 1)
    for v, et in pairs:
        refs[v] = et
    return FlatSnapshot(refs, max_v + 1, wtree=g.wtree)


def snapshot_nbytes(s: FlatSnapshot) -> int:
    """8 bytes per vertex pointer (paper Table 2 'Flat Snap.')."""
    return 8 * s.n


def graph_nbytes(g: Graph, compressed: bool = True, chunked: bool = True) -> int:
    """Aspen memory model (paper §7.1).

    chunked=False emulates the 'Aspen Uncomp.' column: every edge is its
    own 32B functional tree node, every vertex a 48B node.
    compressed=False with chunked=True is the 'No DE' column (8B/element
    chunks).
    """
    VERTEX_NODE = 56 if chunked else 48  # §7.1: 56B with prefix pointers
    total = 0
    for v, et in _VMOD.iter_entries(g.vtree):
        total += VERTEX_NODE
        if et is None:
            continue
        if chunked:
            total += ct.nbytes(et, compressed=compressed)
        else:
            total += ct.uncompressed_tree_bytes(et)
    return total
