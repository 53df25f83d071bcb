"""Breadth-first search, and the check of a BFS parent array.

A parent array is right iff it reaches exactly the vertices the source
reaches, names the source as its own parent, and gives every other
reached vertex a parent that is one of its in-neighbours one level
nearer the source.  Any such array is a right answer: the check does not
ask which of several valid parents was chosen.
"""
from __future__ import annotations

import numpy as np
import torch


class Graph:
    """Edges as two int64 lanes beside the sorted keys (for membership)."""

    def __init__(self, keys: torch.Tensor, n: int):
        self.keys = keys
        self.n = n
        self.src = keys >> 32
        self.dst = keys & 0xFFFFFFFF

    def degrees(self) -> torch.Tensor:
        return torch.bincount(self.src, minlength=self.n)[: self.n]

    def has(self, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        q = (u << 32) | v
        idx = torch.searchsorted(self.keys, q).clamp_max(self.keys.numel() - 1)
        return self.keys[idx] == q


def depths(g: Graph, source: int) -> torch.Tensor:
    """int64 hop count from ``source`` per vertex (-1 = unreached)."""
    dev = g.keys.device
    depth = torch.full((g.n,), -1, dtype=torch.int64, device=dev)
    depth[source] = 0
    frontier = torch.zeros(g.n, dtype=torch.bool, device=dev)
    frontier[source] = True
    level = 0
    while bool(frontier.any()):
        level += 1
        hit = torch.zeros(g.n, dtype=torch.bool, device=dev)
        hit[g.dst[frontier[g.src]]] = True
        frontier = hit & (depth < 0)
        depth[frontier] = level
    return depth


def parents(g: Graph, depth: torch.Tensor, source: int) -> torch.Tensor:
    """One valid parent array for ``depth``: each reached vertex's
    largest in-neighbour one level nearer."""
    ok = (depth[g.src] >= 0) & (depth[g.src] == depth[g.dst] - 1)
    par = torch.full((g.n,), -1, dtype=torch.int64, device=depth.device)
    par.scatter_reduce_(0, g.dst[ok], g.src[ok], reduce="amax")
    par[source] = source
    return par


def parent_errors(g: Graph, par_host: np.ndarray, source: int, depth: torch.Tensor) -> int:
    """Vertices on which ``par_host`` (a parent array as answered) is wrong."""
    par = torch.from_numpy(np.asarray(par_host, dtype=np.int64)).to(depth.device)
    if par.numel() != g.n:
        return g.n
    reached = depth >= 0
    errs = int(((par >= 0) != reached).sum()) + int(par[source] != source)
    v = torch.nonzero(reached & (par >= 0), as_tuple=True)[0]
    v = v[v != source]
    p = par[v]
    inside = p < g.n
    errs += int((~inside).sum())
    v, p = v[inside], p[inside]
    good = g.has(p, v) & (depth[p] == depth[v] - 1)
    return errs + int((~good).sum())
