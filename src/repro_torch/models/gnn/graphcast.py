"""GraphCast-style encoder-processor-decoder mesh GNN (arXiv:2212.12794).

Counterpart of ``repro/models/gnn/graphcast.py``.  graphcast config: 16
processor layers, d_hidden=512, sum aggregation, n_vars=227 input
channels, mesh_refinement=6.

On its own (weather) configuration the model runs on an icosahedral
multimesh (``build_multimesh``, host numpy, the reference's edge array);
on the generic graph shapes the encoder, processor and decoder run over
the given GraphBatch.  Edge and node update MLPs with residuals and
LayerNorm.  Aggregation is ``index_add_`` (the reference's
``jax.ops.segment_sum``; no Pallas kernel there, no hand kernel here).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..._device import resolve
from .. import layers as L
from .common import GraphBatch, aggregate, degrees


def _mlp2(gen: torch.Generator, d_in: int, d_hidden: int, d_out: int, dev) -> Dict[str, Any]:
    return L.mlp_init(gen, d_in, [d_hidden, d_out], torch.float32, device=dev)


def init(gen: torch.Generator, d_in: int, d_hidden: int = 512, n_layers: int = 16,
         d_out: int = 227, d_edge_in: int = 4, device=None) -> Dict[str, Any]:
    """Float32 parameters drawn from ``gen``: the node and edge encoders,
    the decoder, then each layer's edge and node MLPs."""
    dev = resolve(device)
    p: Dict[str, Any] = {
        "enc_node": _mlp2(gen, d_in, d_hidden, d_hidden, dev),
        "enc_edge": _mlp2(gen, d_edge_in, d_hidden, d_hidden, dev),
        "layers": [],
        "dec": _mlp2(gen, d_hidden, d_hidden, d_out, dev),
    }
    for _ in range(n_layers):
        p["layers"].append({
            # edge MLP([e, h_src, h_dst]); node MLP([h, agg_e])
            "edge": _mlp2(gen, 3 * d_hidden, d_hidden, d_hidden, dev),
            "node": _mlp2(gen, 2 * d_hidden, d_hidden, d_hidden, dev),
            "ln_e": L.layernorm_init(d_hidden, device=dev),
            "ln_n": L.layernorm_init(d_hidden, device=dev),
        })
    return p


def forward(params, batch: GraphBatch) -> torch.Tensor:
    n = batch.n_nodes
    src, dst = batch.src.long(), batch.dst.long()
    h = L.mlp(params["enc_node"], batch.x, act=F.silu)
    if batch.edge_attr is not None:
        e = L.mlp(params["enc_edge"], batch.edge_attr, act=F.silu)
    else:
        # structural edge features: normalised degree difference
        deg = degrees(batch)
        ea = torch.stack([deg[src], deg[dst], deg[src] - deg[dst], torch.ones_like(deg[src])],
                         dim=-1)
        e = L.mlp(params["enc_edge"], ea / (1.0 + ea.abs()), act=F.silu)
    for lp in params["layers"]:
        # edge update (interaction network)
        e_in = torch.cat([e, h[src], h[dst]], dim=-1)
        e = e + L.layernorm(lp["ln_e"], L.mlp(lp["edge"], e_in, act=F.silu))
        # node update
        agg = aggregate(e, batch.dst, n, "sum", batch.edge_mask)
        n_in = torch.cat([h, agg], dim=-1)
        h = h + L.layernorm(lp["ln_n"], L.mlp(lp["node"], n_in, act=F.silu))
    return L.mlp(params["dec"], h)


def loss_fn(params, batch: GraphBatch, targets: torch.Tensor) -> torch.Tensor:
    pred = forward(params, batch)
    m = batch.node_mask[:, None].to(pred.dtype)
    return torch.sum(((pred - targets) * m) ** 2) / torch.clamp(m.sum(), min=1.0)


# ---------------------------------------------------------------------------
# icosahedral multimesh (the model's own configuration)
# ---------------------------------------------------------------------------


def build_multimesh(refinement: int) -> np.ndarray:
    """Icosahedron refined ``refinement`` times; returns the multimesh
    edge list (int64 (E, 2), sorted by (src, dst)): the union of every
    refinement level's edges, both directions.

    Nodes at level r: 10*4^r + 2.  The multimesh keeps coarse edges
    alongside fine ones (GraphCast §3.2).
    """
    # the 12 icosahedron vertices are numbered as the reference numbers
    # them; a midpoint's id depends only on the order in which its edge is
    # first met, so the vertex positions are not needed for the edges
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ]
    )

    def face_edges(fs):
        return np.concatenate([fs[:, [0, 1]], fs[:, [1, 2]], fs[:, [2, 0]]])

    all_edges = [face_edges(faces)]
    n_verts = 12
    for _ in range(refinement):
        midpoint: Dict = {}
        new_faces = []

        def mid(i, j):
            nonlocal n_verts
            key = (min(i, j), max(i, j))
            if key not in midpoint:
                midpoint[key] = n_verts
                n_verts += 1
            return midpoint[key]

        for a, b, c in faces.tolist():
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        faces = np.asarray(new_faces)
        all_edges.append(face_edges(faces))
    e = np.concatenate(all_edges)
    e = np.concatenate([e, e[:, ::-1]])
    keys = np.unique((e[:, 0].astype(np.int64) << 32) | e[:, 1].astype(np.int64))
    return np.stack([keys >> 32, keys & 0xFFFFFFFF], axis=1)
