"""Aspen graph on the device: CSR over a sorted pool of packed edge keys.

Counterpart of the raw half of ``repro/core/flat_graph.py`` (lines
37-257 and 500-527; the compressed pool is not ported yet).  The whole
edge set is ONE flat C-tree over packed 64-bit keys ``(src << 32) | dst``:
CSR's edge array *is* the sorted pool, and each vertex's adjacency list
is a contiguous key range.  A batch update is the flat C-tree rank-merge
over packed keys followed by an O(n) offsets rebuild (one searchsorted).

The reference's buffer donation has no counterpart: the old pool is
freed when the last version holding it is collected.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import resolve
from . import flat_ctree as fct

SENT64 = fct.SENTINEL64


class FlatGraph(NamedTuple):
    """Immutable graph snapshot.  ``weights`` optionally carries one
    float32 per pool slot, parallel to ``keys``: every rank-merge or
    compaction permutes it alongside the keys, inserting a duplicate key
    overwrites its weight, deleting a key drops it."""

    offsets: torch.Tensor  # int32[n+1] CSR offsets (valid prefix of pool)
    keys: torch.Tensor  # int64[cap] sorted packed (src<<32|dst); pad SENT64
    m: torch.Tensor  # int32 0-dim: valid edge count
    weights: Optional[torch.Tensor] = None  # float32[cap] per-edge values (pad 0)

    @property
    def n(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def edge_capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def device(self) -> torch.device:
        return self.keys.device


def pack(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    return (src.to(torch.int64) << 32) | dst.to(torch.int64)


def unpack(keys: torch.Tensor):
    return (keys >> 32).to(torch.int32), (keys & 0xFFFFFFFF).to(torch.int32)


def _offsets_from_keys(keys: torch.Tensor, m: torch.Tensor, n: int) -> torch.Tensor:
    """offsets[v] = #edges with src < v; one vectorized searchsorted."""
    bounds = torch.arange(n + 1, dtype=torch.int64, device=keys.device) << 32
    offs = torch.searchsorted(keys, bounds).to(torch.int32)
    return torch.minimum(offs, m.to(torch.int32))


def from_edges(
    n: int,
    edges: np.ndarray,
    edge_capacity: int | None = None,
    weights: np.ndarray | None = None,
    device=None,
) -> FlatGraph:
    """Build from a (k, 2) directed edge array (dedups; a duplicated edge
    keeps the FIRST occurrence's weight).  The keys are sorted on the
    device, so a large edge set costs one host->device copy."""
    dev = resolve(device)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    packed = torch.from_numpy((edges[:, 0] << 32) | edges[:, 1]).to(dev)
    w = None
    if weights is None:
        keys = torch.sort(packed).values
    else:
        keys, order = torch.sort(packed, stable=True)
        w = torch.from_numpy(np.asarray(weights, dtype=np.float32).reshape(-1)).to(dev)[order]
    keep = fct._dedup_mask(keys, keys.shape[0])
    if edge_capacity is None:
        edge_capacity = fct.grown_capacity(int(keep.sum()))
    pool = fct._compact(keys, keep, edge_capacity, vals=w)
    return FlatGraph(_offsets_from_keys(pool.data, pool.n, n), pool.data, pool.n, pool.vals)


def from_state(offsets, keys, m, weights=None, device=None) -> FlatGraph:
    """The port's FlatGraph from the reference's leaves as numpy arrays
    (``np.asarray(g.offsets)``, ``np.asarray(g.keys)``, ``int(g.m)``,
    ``np.asarray(g.weights)``)."""
    dev = resolve(device)
    return FlatGraph(
        torch.from_numpy(np.array(offsets, dtype=np.int32)).to(dev),
        torch.from_numpy(np.array(keys, dtype=np.int64)).to(dev),
        torch.tensor(int(m), dtype=torch.int32, device=dev),
        None if weights is None else torch.from_numpy(np.array(weights, np.float32)).to(dev),
    )


def with_unit_weights(g: FlatGraph) -> FlatGraph:
    """Attach a unit value array to an unweighted graph (the upgrade an
    unweighted pool takes when its first weighted batch arrives)."""
    if g.weights is not None:
        return g
    return g._replace(weights=torch.ones(g.edge_capacity, dtype=torch.float32, device=g.device))


def to_edge_array(g: FlatGraph) -> np.ndarray:
    k = g.keys[: int(g.m)].cpu().numpy()
    return np.stack([k >> 32, k & 0xFFFFFFFF], axis=1)


def to_weight_array(g: FlatGraph) -> np.ndarray | None:
    """Per-edge weights aligned with ``to_edge_array`` (None when
    unweighted)."""
    return None if g.weights is None else g.weights[: int(g.m)].cpu().numpy()


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------


def degrees(g: FlatGraph) -> torch.Tensor:
    return torch.diff(g.offsets)


def has_edge(g: FlatGraph, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    q = pack(src, dst)
    idx = torch.searchsorted(g.keys, q).clamp_max_(g.keys.shape[0] - 1)
    return g.keys[idx] == q


# ---------------------------------------------------------------------------
# batch updates: the streaming hot path
# ---------------------------------------------------------------------------


def insert_edges(
    g: FlatGraph, batch: fct.FlatCTree, out_cap: int, n_out: int | None = None
) -> FlatGraph:
    """InsertEdges: rank-merge batch keys into the pool, rebuild offsets.
    ``batch`` is a FlatCTree of packed keys (sorted, deduped, padded);
    ``n_out`` grows the vertex count when the batch names new sources."""
    pool = fct.FlatCTree(g.keys, g.m, g.weights)
    merged = fct.union_merge(pool, batch, out_cap)
    n = g.n if n_out is None else n_out
    return FlatGraph(
        _offsets_from_keys(merged.data, merged.n, n), merged.data, merged.n, merged.vals
    )


def delete_edges(g: FlatGraph, batch: fct.FlatCTree, out_cap: int) -> FlatGraph:
    pool = fct.FlatCTree(g.keys, g.m, g.weights)
    out = fct.difference(pool, batch, out_cap)
    return FlatGraph(_offsets_from_keys(out.data, out.n, g.n), out.data, out.n, out.vals)


def insert_edges_device(
    g: FlatGraph,
    batch: fct.FlatCTree,
    out_cap: int | None = None,
    *,
    n_out: int | None = None,
) -> FlatGraph:
    """Host-free InsertEdges: ``batch`` is already on the device (see
    ``fct.from_device``).  ``out_cap=None`` reads two device scalars to
    size the output exactly, which waits for the previous merge;
    pipelines pass ``out_cap`` from host-tracked counts, as
    ``AspenStream`` does."""
    if out_cap is None:
        out_cap = max(g.edge_capacity, fct.grown_capacity(int(g.m) + int(batch.n)))
    return insert_edges(g, batch, out_cap, n_out)


def delete_edges_device(
    g: FlatGraph, batch: fct.FlatCTree, out_cap: int | None = None
) -> FlatGraph:
    """Host-free DeleteEdges."""
    return delete_edges(g, batch, g.edge_capacity if out_cap is None else out_cap)


def batch_from_edges(
    edges: np.ndarray, cap: int | None = None, weights: np.ndarray | None = None, device=None
) -> fct.FlatCTree:
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    keys = (edges[:, 0] << 32) | edges[:, 1]
    return fct.from_array(keys, cap=cap, dtype=torch.int64, vals=weights, device=device)


def insert_edges_host(
    g: FlatGraph, edges: np.ndarray, weights: np.ndarray | None = None
) -> FlatGraph:
    """Host-driven insert with the capacity policy (quantized growth).  A
    weighted batch against an unweighted pool upgrades the pool to unit
    weights first (insert overwrites the weight of an existing edge)."""
    if weights is not None and g.weights is None:
        g = with_unit_weights(g)
    batch = batch_from_edges(edges, weights=weights, device=g.device)
    need = int(g.m) + int(batch.n)
    cap = max(g.edge_capacity, fct.grown_capacity(need))
    return insert_edges(g, batch, cap)


def delete_edges_host(g: FlatGraph, edges: np.ndarray) -> FlatGraph:
    batch = batch_from_edges(edges, device=g.device)
    return delete_edges(g, batch, g.edge_capacity)
