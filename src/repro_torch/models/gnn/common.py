"""Shared GNN substrate: GraphBatch + segment aggregation.

Counterpart of ``repro/models/gnn/common.py``.  Aggregation is a gather
plus a scatter-reduce over an edge index (``index_add_`` where the
reference has ``jax.ops.segment_sum``, ``scatter_reduce`` for its
``segment_max``), built here once and reused by every GNN.  The edge
arrays come straight from the Aspen flat graph pool
(``core/flat_graph.py``): a streaming graph update produces a new
GraphBatch from the new snapshot's ``keys``.

Fixed shapes: edges are padded (``edge_mask`` carries validity), as in
the reference.  ``params_from_numpy`` (from ``models/layers.py``, shared
with the LM) carries the reference's parameter trees across, since
``jax.random`` draws cannot be reproduced in torch.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from ..._device import resolve
from ...core import flat_graph as fg
from ..layers import params_from_numpy  # noqa: F401  (re-exported)


class GraphBatch(NamedTuple):
    """A (possibly batched) graph in padded edge-list form."""

    x: torch.Tensor  # (N, d_feat) node features
    src: torch.Tensor  # (E,) int32 edge sources (padding -> N-1, masked)
    dst: torch.Tensor  # (E,) int32 edge destinations
    edge_mask: torch.Tensor  # (E,) bool
    node_mask: torch.Tensor  # (N,) bool
    edge_attr: Optional[torch.Tensor] = None  # (E, d_edge) e.g. distances
    graph_ids: Optional[torch.Tensor] = None  # (N,) for batched small graphs

    @property
    def n_nodes(self) -> int:
        return self.x.shape[0]

    @property
    def n_edges(self) -> int:
        return self.src.shape[0]


def _segment_sum(msg: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    return msg.new_zeros((n,) + tuple(msg.shape[1:])).index_add_(0, idx, msg)


def aggregate(msg: torch.Tensor, dst: torch.Tensor, n: int, op: str = "sum",
              edge_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Segment-reduce messages (E, ...) to n nodes by ``dst`` (in
    [0, n)): sum, mean (over the unmasked edges, at least 1) or max.
    Masked edges count as zero (``finfo.min`` under max); a node with no
    edge at all gets 0 under sum and mean and ``-inf`` under max, as
    ``jax.ops.segment_max`` gives."""
    if edge_mask is not None:
        em = edge_mask.reshape((-1,) + (1,) * (msg.dim() - 1))
        if op == "max":
            msg = torch.where(em, msg, torch.finfo(msg.dtype).min)
        else:
            msg = msg * em.to(msg.dtype)
    idx = dst.long()
    if op == "sum":
        return _segment_sum(msg, idx, n)
    if op == "mean":
        s = _segment_sum(msg, idx, n)
        ones = (edge_mask.to(msg.dtype) if edge_mask is not None
                else torch.ones(dst.shape, dtype=msg.dtype, device=msg.device))
        cnt = _segment_sum(ones, idx, n)
        return s / torch.clamp(cnt.reshape((n,) + (1,) * (msg.dim() - 1)), min=1.0)
    if op == "max":
        out = torch.full((n,) + tuple(msg.shape[1:]), -torch.inf, dtype=msg.dtype,
                         device=msg.device)
        index = idx.reshape((-1,) + (1,) * (msg.dim() - 1)).expand_as(msg)
        return out.scatter_reduce_(0, index, msg, "amax", include_self=False)
    raise ValueError(op)


def degrees(batch: GraphBatch) -> torch.Tensor:
    """In-degree over the unmasked edges, float32 (N,)."""
    return _segment_sum(batch.edge_mask.to(torch.float32), batch.dst.long(), batch.n_nodes)


def sym_norm_coeff(batch: GraphBatch) -> torch.Tensor:
    """GCN symmetric normalization 1/sqrt(d_i d_j) per edge (+self loops
    handled by callers)."""
    inv_sqrt = torch.rsqrt(degrees(batch) + 1.0)  # +1 for self loop
    return inv_sqrt[batch.src.long()] * inv_sqrt[batch.dst.long()]


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


def batch_from_edges(
    n: int,
    edges: np.ndarray,
    x: np.ndarray,
    edge_capacity: Optional[int] = None,
    edge_attr: Optional[np.ndarray] = None,
    device=None,
) -> GraphBatch:
    """GraphBatch from a host (k, 2) edge array, padded to
    ``edge_capacity`` with masked edges (n-1, n-1); ``edge_attr`` (k, ...)
    becomes float32 with zero rows for the padding."""
    dev = resolve(device)
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    E = e.shape[0]
    cap = edge_capacity or E
    src = np.full(cap, n - 1, dtype=np.int32)
    dst = np.full(cap, n - 1, dtype=np.int32)
    src[:E], dst[:E] = e[:, 0], e[:, 1]
    mask = np.zeros(cap, dtype=bool)
    mask[:E] = True
    ea = None
    if edge_attr is not None:
        ea_np = np.zeros((cap,) + edge_attr.shape[1:], dtype=np.float32)
        ea_np[:E] = edge_attr
        ea = torch.from_numpy(ea_np).to(dev)
    return GraphBatch(
        x=torch.as_tensor(np.asarray(x, np.float32)).to(dev),
        src=torch.from_numpy(src).to(dev),
        dst=torch.from_numpy(dst).to(dev),
        edge_mask=torch.from_numpy(mask).to(dev),
        node_mask=torch.ones((n,), dtype=torch.bool, device=dev),
        edge_attr=ea,
    )


def batch_from_flat_graph(g: fg.FlatGraph, x: torch.Tensor) -> GraphBatch:
    """View of an Aspen flat graph as a GraphBatch on the graph's device:
    the streaming store feeds the GNN directly.  The pool's pad slots
    (SENT64 keys) become masked edges (n-1, n-1)."""
    src, dst = fg.unpack(g.keys)
    n = g.n
    valid = torch.arange(g.edge_capacity, device=g.device) < g.m
    return GraphBatch(
        x=x,
        src=torch.where(valid, src, n - 1).to(torch.int32),
        dst=torch.where(valid, dst, n - 1).to(torch.int32),
        edge_mask=valid,
        node_mask=torch.ones((n,), dtype=torch.bool, device=g.device),
    )


def random_batch(gen: torch.Generator, n: int, e: int, d_feat: int, batched: int = 0,
                 device=None) -> GraphBatch:
    """Synthetic graph for smoke tests and benchmarks, drawn from ``gen``
    (on the generator's device) and placed on ``device``.  With
    ``batched``, node i belongs to graph ``i // (n // batched)``, as in the
    reference (int64 ``graph_ids``)."""
    dev = resolve(device)
    src = torch.randint(0, n, (e,), generator=gen, device=gen.device, dtype=torch.int32)
    dst = torch.randint(0, n, (e,), generator=gen, device=gen.device, dtype=torch.int32)
    x = torch.randn((n, d_feat), generator=gen, device=gen.device, dtype=torch.float32)
    gid = None
    if batched:
        gid = torch.arange(n, device=dev) // (n // batched)
    return GraphBatch(
        x=x.to(dev), src=src.to(dev), dst=dst.to(dev),
        edge_mask=torch.ones((e,), dtype=torch.bool, device=dev),
        node_mask=torch.ones((n,), dtype=torch.bool, device=dev),
        graph_ids=gid,
    )
