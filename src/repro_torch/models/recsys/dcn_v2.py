"""DCN-v2 (arXiv:2008.13535): dcn-v2 config.

Counterpart of ``repro/models/recsys/dcn_v2.py:21-90``.  13 dense + 26
sparse (16-dim) features -> explicit cross layers
``x_{l+1} = x0 * (W_l x_l + b_l) + x_l`` (full rank) stacked with a deep
MLP (1024-1024-512) -> logit.  Heads for the four recsys shapes: train
(BCE loss), serve_p99 / serve_bulk (sigmoid scores), retrieval_cand (one
user vector against the candidate embeddings: one product and
``torch.topk``, never a loop).  Parameters are the reference's tree:
``{"embed": {"tables"}, "cross": [{"w", "b"}, ...], "mlp", "logit"}``
(and ``"candidates"`` with ``n_candidates``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from ..._device import resolve
from .. import layers as L
from .embedding import init_field_tables, lookup_onehot


def init(
    gen: torch.Generator,
    n_dense: int = 13,
    n_sparse: int = 26,
    embed_dim: int = 16,
    vocab_per_field: int = 100_000,
    n_cross: int = 3,
    mlp_dims: Tuple[int, ...] = (1024, 1024, 512),
    n_candidates: int = 0,
    dtype=torch.float32,
    device=None,
) -> Dict[str, Any]:
    """Random parameters drawn from ``gen`` at the reference's scales."""
    dev = resolve(device)
    d0 = n_dense + n_sparse * embed_dim
    p: Dict[str, Any] = {
        "embed": init_field_tables(gen, n_sparse, vocab_per_field, embed_dim, dtype, dev),
        "cross": [],
        "mlp": L.mlp_init(gen, d0, list(mlp_dims), dtype, device=dev),
        "logit": L.mlp_init(gen, mlp_dims[-1] + d0, [1], dtype, device=dev),
    }
    for _ in range(n_cross):
        p["cross"].append({
            "w": L._normal(gen, (d0, d0), d0 ** -0.5, dtype, dev),
            "b": torch.zeros((d0,), dtype=dtype, device=dev),
        })
    if n_candidates:
        p["candidates"] = L._normal(gen, (n_candidates, mlp_dims[-1]), 1.0, dtype, dev)
    return p


def trunk(params, dense: torch.Tensor, sparse_ids: torch.Tensor):
    """Returns (cross_out (B, d0), deep_out (B, mlp[-1]))."""
    emb = lookup_onehot(params["embed"], sparse_ids)  # (B, F, D)
    x0 = torch.cat([dense, emb.reshape(emb.shape[0], -1)], dim=-1)
    x = x0
    for cp in params["cross"]:
        x = x0 * (L._einsum("bd,de->be", x, cp["w"]) + cp["b"]) + x
    deep = L.mlp(params["mlp"], x0, act=torch.relu, final_act=True)
    return x, deep


def forward(params, dense: torch.Tensor, sparse_ids: torch.Tensor) -> torch.Tensor:
    """CTR logits (B,)."""
    cross, deep = trunk(params, dense, sparse_ids)
    both = torch.cat([cross, deep], dim=-1)
    return L.mlp(params["logit"], both)[:, 0]


def loss_fn(params, dense, sparse_ids, labels) -> torch.Tensor:
    """Binary cross entropy in the reference's stable form (the
    train_batch shape)."""
    logits = forward(params, dense, sparse_ids)
    return torch.mean(
        torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))
    )


def serve(params, dense, sparse_ids) -> torch.Tensor:
    """CTR scores (serve_p99 / serve_bulk shapes)."""
    return torch.sigmoid(forward(params, dense, sparse_ids))


def retrieval(params, dense, sparse_ids, top_k: int = 100):
    """retrieval_cand: score the query against ``params["candidates"]``
    with one product, return the top-k (scores, ids)."""
    _, user_vec = trunk(params, dense, sparse_ids)  # (1, d)
    scores = L._einsum("bd,cd->bc", user_vec, params["candidates"])
    return torch.topk(scores, top_k, dim=-1)
