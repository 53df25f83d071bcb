"""rMAT edges drawn on the device from a seed (paper §7.4: a=0.5, b=c=0.1, d=0.3).

Frozen copy of the port's proof script's generator (``chip_smoke.py``:
``rmat_draws_device`` and ``rmat_keys_device``), with the device made an
argument, so that the benchmark's inputs stay put when the program's
scripts change.  Draws are made in a few large calls from one
``torch.Generator`` on the device; the same seed gives the same draws on
the same device type.
"""
from __future__ import annotations

import numpy as np
import torch

def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit generator seed for input stream ``stream`` of a run seeded
    ``seed`` (any non-negative whole number)."""
    return (int(seed) * 0x9E3779B97F4A7C15 + 0xBF58476D1CE4E5B9 * (stream + 1)) % (1 << 63)


def rmat_draws(log_n: int, n_draws: int, seed: int, device, communities: int = 1,
               rmat: dict = None):
    """``n_draws`` rMAT (src, dst) int64 pairs, directed, with duplicates
    and self loops; ``rmat`` holds the quadrant probabilities a, b, c
    (d = 1 - a - b - c; the paper's 0.5, 0.1, 0.1, 0.3 when None).  With ``communities`` > 1 the draws split into that
    many equal runs, run c over its own 2^log_n ids numbered from
    c << log_n (disjoint rMAT communities)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rmat = rmat or {"a": 0.5, "b": 0.1, "c": 0.1}
    a, b, c = rmat["a"], rmat["b"], rmat["c"]
    src = torch.zeros(n_draws, dtype=torch.int64, device=device)
    dst = torch.zeros_like(src)
    for _ in range(log_n):
        r = torch.rand(n_draws, generator=gen, device=device)
        src_bit = r >= a + b
        dst_bit = torch.where(src_bit, r >= a + b + c, r >= a)
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    if communities > 1:
        off = (torch.arange(n_draws, device=device) * communities // n_draws) << log_n
        src, dst = src + off, dst + off
    return src, dst


def symmetric_keys(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Packed ``(src << 32) | dst`` keys of both directions, sorted,
    unique and without self loops (the graph the paper runs)."""
    keys = torch.unique(torch.cat([(src << 32) | dst, (dst << 32) | src]))
    return keys[(keys >> 32) != (keys & 0xFFFFFFFF)]


def symmetric_edges(src: torch.Tensor, dst: torch.Tensor) -> np.ndarray:
    """A batch as a writer hands it over: host (k, 2) int64 edges, the
    draws and then their reverses, self loops dropped, duplicates kept
    and unsorted (the program sorts and deduplicates)."""
    keep = src != dst
    s, d = src[keep], dst[keep]
    return torch.stack([torch.cat([s, d]), torch.cat([d, s])], 1).cpu().numpy()


def graph_keys(cfg: dict, seed: int, device) -> torch.Tensor:
    """The configuration's initial graph as sorted unique keys on ``device``."""
    src, dst = rmat_draws(cfg["log_n"], cfg["graph_draws"], sub_seed(seed, 0), device,
                          cfg.get("communities", 1), cfg.get("rmat"))
    return symmetric_keys(src, dst)


def batch_edges(cfg: dict, draws: int, seed: int, stream: int, device) -> np.ndarray:
    """One update batch of ``draws`` rMAT draws in the configuration's
    id layout (communities kept), as ``symmetric_edges``."""
    src, dst = rmat_draws(cfg["log_n"], draws, sub_seed(seed, stream), device,
                          cfg.get("communities", 1), cfg.get("rmat"))
    return symmetric_edges(src, dst)
