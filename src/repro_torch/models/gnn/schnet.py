"""SchNet (arXiv:1706.08566): continuous-filter convolutions.

Counterpart of ``repro/models/gnn/schnet.py``.  schnet config:
n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.  Edges carry
interatomic distances (``edge_attr[:, 0]``); filters are MLPs over a
Gaussian RBF expansion under a cosine cutoff envelope; messages are the
neighbours' states filtered elementwise, summed into each atom
(``aggregate``: ``index_add_``, the reference's ``jax.ops.segment_sum``;
no hand kernel, none in the reference either).

The molecule shape batches many small graphs: ``graph_ids`` drive a
final per-molecule sum (``readout_per_molecule``).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from ..._device import resolve
from .. import layers as L
from .common import GraphBatch, _segment_sum, aggregate


def rbf_expand(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Gaussian radial basis: (E,) -> (E, n_rbf)."""
    centers = torch.linspace(0.0, cutoff, n_rbf, dtype=torch.float32, device=dist.device)
    gamma = n_rbf / cutoff
    return torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2)


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """softplus(x) - log 2, with softplus as ``jax.nn.softplus`` computes it,
    ``logaddexp(x, 0)``: its gradient at 0 is 1/2 (an atom with no
    neighbour meets x = 0 exactly), and above 20 it is not cut to x as
    torch's ``softplus`` is."""
    return torch.logaddexp(x, x.new_zeros(())) - math.log(2.0)


def init(gen: torch.Generator, d_in: int, d_hidden: int = 64, n_interactions: int = 3,
         n_rbf: int = 300, n_out: int = 1, device=None) -> Dict[str, Any]:
    """Float32 parameters drawn from ``gen``: embed, then each
    interaction's filter, in_proj and out_proj, then the readout."""
    dev = resolve(device)
    p: Dict[str, Any] = {
        "embed": L.mlp_init(gen, d_in, [d_hidden], torch.float32, device=dev),
        "interactions": [],
    }
    for _ in range(n_interactions):
        p["interactions"].append({
            "filter": L.mlp_init(gen, n_rbf, [d_hidden, d_hidden], torch.float32, device=dev),
            "in_proj": L.mlp_init(gen, d_hidden, [d_hidden], torch.float32, bias=False,
                                  device=dev),
            "out_proj": L.mlp_init(gen, d_hidden, [d_hidden, d_hidden], torch.float32,
                                   device=dev),
        })
    p["readout"] = L.mlp_init(gen, d_hidden, [d_hidden // 2, n_out], torch.float32, device=dev)
    return p


def forward(params, batch: GraphBatch, cutoff: float = 10.0) -> torch.Tensor:
    """Per-atom outputs (N, n_out); the per-molecule sum is
    ``readout_per_molecule``."""
    if batch.edge_attr is None:
        raise ValueError("SchNet needs distances in edge_attr")
    dist = batch.edge_attr[..., 0]
    h = L.mlp(params["embed"], batch.x, act=shifted_softplus)
    # n_rbf is structural: the filter MLP's input width
    n_rbf = params["interactions"][0]["filter"]["ws"][0].shape[0]
    rbf = rbf_expand(dist, n_rbf, cutoff)
    # smooth cutoff envelope
    env = 0.5 * (torch.cos(math.pi * torch.clamp(dist / cutoff, 0, 1)) + 1.0)
    src = batch.src.long()
    for ip in params["interactions"]:
        w = L.mlp(ip["filter"], rbf, act=shifted_softplus) * env[:, None]
        hin = L.mlp(ip["in_proj"], h)
        msg = hin[src] * w  # continuous-filter conv
        agg = aggregate(msg, batch.dst, batch.n_nodes, "sum", batch.edge_mask)
        h = h + L.mlp(ip["out_proj"], agg, act=shifted_softplus)
    return L.mlp(params["readout"], h, act=shifted_softplus)


def readout_per_molecule(atom_out: torch.Tensor, graph_ids: torch.Tensor, n_graphs: int,
                         node_mask: torch.Tensor) -> torch.Tensor:
    m = node_mask[:, None].to(atom_out.dtype)
    return _segment_sum(atom_out * m, graph_ids.long(), n_graphs)


def loss_fn(params, batch: GraphBatch, targets: torch.Tensor, n_graphs: int) -> torch.Tensor:
    atom_out = forward(params, batch)
    pred = readout_per_molecule(atom_out, batch.graph_ids, n_graphs, batch.node_mask)
    return torch.mean((pred[:, 0] - targets) ** 2)
