"""Personalized PageRank by power iteration, one reset row at a time.

Each iteration: every vertex u with out-degree d(u) > 0 sends pr[u] / d(u)
along each out-edge; the mass of vertices with no out-edge goes back to
the reset row; ``pr' = (1 - damping) * reset + damping * (received +
dangling_mass * reset)``.  The first iterate is the reset row itself.
"""
from __future__ import annotations

import torch

from .bfs import Graph


def pagerank(g: Graph, reset: torch.Tensor, iters: int, damping: float,
             dtype=torch.float64) -> torch.Tensor:
    """Scores of one reset row (``reset``: [n]) after ``iters`` iterations,
    computed in ``dtype``."""
    deg = torch.bincount(g.src, minlength=g.n)[: g.n].to(dtype)
    dangling = deg == 0
    safe = torch.where(dangling, torch.ones_like(deg), deg)
    reset = reset.to(dtype)
    pr = reset.clone()
    for _ in range(iters):
        send = torch.where(dangling, torch.zeros_like(pr), pr / safe)
        got = torch.zeros_like(pr).index_add_(0, g.dst, send[g.src])
        dang = torch.where(dangling, pr, torch.zeros_like(pr)).sum()
        pr = (1.0 - damping) * reset + damping * (got + dang * reset)
    return pr
