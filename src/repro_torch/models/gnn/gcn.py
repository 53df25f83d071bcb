"""GCN (Kipf & Welling, arXiv:1609.02907): gcn-cora config.

Counterpart of ``repro/models/gnn/gcn.py``.  Propagation:
H' = sigma(D^-1/2 (A+I) D^-1/2 H W) by segment-sum aggregation over the
edge list.  ``use_spmm_kernel`` is accepted and ignored, as in the
reference: no model calls the block SpMM there, which is reached through
``kernels.ops.spmm_from_edges``.  Parameters are ``{"ws": [W_0, ...]}``.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from ..._device import resolve
from .. import layers as L
from .common import GraphBatch, aggregate, degrees, sym_norm_coeff


def init(gen: torch.Generator, d_in: int, d_hidden: int, n_classes: int, n_layers: int = 2,
         device=None) -> Dict[str, Any]:
    """Weights drawn from ``gen``: N(0, 1/d_in) per matrix."""
    dev = resolve(device)
    dims = [d_hidden] * (n_layers - 1) + [n_classes]
    ws: List[torch.Tensor] = []
    d_prev = d_in
    for d in dims:
        ws.append(L._normal(gen, (d_prev, d), d_prev ** -0.5, torch.float32, dev))
        d_prev = d
    return {"ws": ws}


def forward(params, batch: GraphBatch, use_spmm_kernel: bool = False) -> torch.Tensor:
    h = batch.x
    coeff = sym_norm_coeff(batch)
    deg = degrees(batch) + 1.0  # self loop with 1/deg normalization
    src = batch.src.long()
    for i, w in enumerate(params["ws"]):
        h = h @ w
        agg = aggregate(h[src] * coeff[:, None], batch.dst, batch.n_nodes, "sum",
                        batch.edge_mask)
        h = agg + h / deg[:, None]
        if i < len(params["ws"]) - 1:
            h = torch.relu(h)
    return h


def loss_fn(params, batch: GraphBatch, labels: torch.Tensor,
            label_mask: torch.Tensor) -> torch.Tensor:
    logits = forward(params, batch)
    return L.cross_entropy(logits, labels, label_mask.to(torch.float32))
