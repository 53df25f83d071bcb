"""GraphSAGE (arXiv:1706.02216): graphsage-reddit config.

Counterpart of ``repro/models/gnn/graphsage.py``.  Two regimes:
  * full-graph: mean aggregation by segment-sum over the whole edge set;
  * sampled minibatch (``minibatch_lg``): fixed-fanout neighbour tensors
    (B, S1, d), (B, S1, S2, d) from ``data/pipeline.NeighborSampler``,
    aggregated with the fanout kernel (``use_kernel=True``) or its torch
    expression.

W_self / W_neigh concatenation form, per the paper.  Parameters are a
plain dict ``{"layers": [{"w_self": (d_in, d), "w_neigh": (d_in, d)}, ...]}``
of float32 tensors, the reference's tree.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence

import torch

from ..._device import resolve
from ...kernels import ops as kops
from .. import layers as L
from .common import GraphBatch, aggregate


def init(gen: torch.Generator, d_in: int, d_hidden: int, n_classes: int, n_layers: int = 2,
         device=None) -> Dict[str, Any]:
    """Weights drawn from ``gen``: N(0, 1/d_in) per matrix."""
    dev = resolve(device)
    dims = [d_hidden] * (n_layers - 1) + [n_classes]
    layers = []
    d_prev = d_in
    for d in dims:
        layers.append({
            "w_self": L._normal(gen, (d_prev, d), d_prev ** -0.5, torch.float32, dev),
            "w_neigh": L._normal(gen, (d_prev, d), d_prev ** -0.5, torch.float32, dev),
        })
        d_prev = d
    return {"layers": layers}


def forward_full(params, batch: GraphBatch) -> torch.Tensor:
    """Full-graph forward: mean-aggregate all neighbours each layer."""
    h = batch.x
    n_layers = len(params["layers"])
    src = batch.src.long()
    for i, lp in enumerate(params["layers"]):
        agg = aggregate(h[src], batch.dst, batch.n_nodes, "mean", batch.edge_mask)
        h = h @ lp["w_self"] + agg @ lp["w_neigh"]
        if i < n_layers - 1:
            h = torch.relu(h)
    return h


def forward_sampled(params, x_self: torch.Tensor, neigh_feats: Sequence[torch.Tensor],
                    neigh_masks: Sequence[torch.Tensor], use_kernel: bool = False) -> torch.Tensor:
    """Sampled minibatch forward (2-layer case).

    x_self: (B, d); neigh_feats = [(B, S1, d), (B, S1, S2, d)];
    neigh_masks = [(B, S1), (B, S1, S2)].  With ``use_kernel`` each of
    the three mean aggregations is one fanout kernel launch over the
    leading axes flattened ((B * S1, S2, d), then (B, S1, d) twice).
    """
    if len(params["layers"]) != 2:
        raise ValueError("sampled path implements 2 hops")
    l1, l2 = params["layers"]

    def agg_mean(f, m):
        if use_kernel:
            flat_f = f.reshape((-1,) + tuple(f.shape[-2:]))
            flat_m = m.reshape((-1, m.shape[-1]))
            out = kops.fanout_aggregate(flat_f, flat_m, "mean")
            return out.reshape(tuple(f.shape[:-2]) + (f.shape[-1],))
        mm = m[..., None].to(f.dtype)
        return (f * mm).sum(-2) / torch.clamp(mm.sum(-2), min=1.0)

    # layer 1 applied at depth-1 nodes: aggregate their (depth-2) neighbours
    agg2 = agg_mean(neigh_feats[1], neigh_masks[1])  # (B, S1, d)
    h1 = torch.relu(neigh_feats[0] @ l1["w_self"] + agg2 @ l1["w_neigh"])
    # layer 1 at the batch nodes themselves
    agg1_self = agg_mean(neigh_feats[0], neigh_masks[0])  # (B, d)
    h0 = torch.relu(x_self @ l1["w_self"] + agg1_self @ l1["w_neigh"])
    # layer 2 at batch nodes: aggregate depth-1 hidden states
    agg_h1 = agg_mean(h1, neigh_masks[0])  # (B, f)
    return h0 @ l2["w_self"] + agg_h1 @ l2["w_neigh"]


def loss_fn_full(params, batch: GraphBatch, labels, label_mask):
    logits = forward_full(params, batch)
    return L.cross_entropy(logits, labels, label_mask.to(torch.float32))


def loss_fn_sampled(params, x_self, neigh_feats, neigh_masks, labels):
    logits = forward_sampled(params, x_self, neigh_feats, neigh_masks)
    return L.cross_entropy(logits, labels)
