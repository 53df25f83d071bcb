"""rMAT edge-stream generator (Chakrabarti et al. [20]; paper §7.4 uses
a=0.5, b=c=0.1, d=0.3).  Fully vectorized: each of the log2(n) bit levels
draws one quadrant choice per edge.

Port copy of ``repro/data/rmat.py`` (numpy only), unchanged apart from this note.
"""
from __future__ import annotations

import numpy as np


def rmat_edges(
    log_n: int,
    n_edges: int,
    a: float = 0.5,
    b: float = 0.1,
    c: float = 0.1,
    seed: int = 0,
) -> np.ndarray:
    """Returns (n_edges, 2) int64 directed edges over 2**log_n vertices.
    May contain duplicates (as the paper notes for its generator)."""
    rng = np.random.default_rng(seed)
    src = np.zeros(n_edges, dtype=np.int64)
    dst = np.zeros(n_edges, dtype=np.int64)
    p_right = b + (1.0 - a - b - c)  # P(dst bit = 1)
    for level in range(log_n):
        u = rng.random(n_edges)
        v = rng.random(n_edges)
        src_bit = (u < (c + (1.0 - a - b - c))).astype(np.int64)
        # correlated quadrant draw: pick quadrant by joint probabilities
        r = rng.random(n_edges)
        q_ab = a + b
        src_bit = (r >= q_ab).astype(np.int64)  # rows c,d
        dst_bit = np.where(
            src_bit == 0,
            (r >= a).astype(np.int64),  # within top: a vs b
            (r >= q_ab + c).astype(np.int64),  # within bottom: c vs d
        )
        src = (src << 1) | src_bit
        dst = (dst << 1) | dst_bit
    return np.stack([src, dst], axis=1)


def rmat_update_stream(log_n: int, n_updates: int, seed: int = 1) -> np.ndarray:
    """Directed insert stream, duplicates allowed (paper §7.4 methodology)."""
    return rmat_edges(log_n, n_updates, seed=seed)


def symmetrize(edges: np.ndarray) -> np.ndarray:
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    both = np.concatenate([e, e[:, ::-1]])
    keys = np.unique((both[:, 0] << 32) | both[:, 1])
    out = np.stack([keys >> 32, keys & 0xFFFFFFFF], axis=1)
    return out[out[:, 0] != out[:, 1]]  # drop self loops
