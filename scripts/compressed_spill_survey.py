#!/usr/bin/env python3
"""Which graphs the compressed device layout can hold.

    PYTHONPATH=src python scripts/compressed_spill_survey.py

The layout (``repro_torch/core/compressed.py``, the reference's
``repro/core/compressed.py``) cuts the src-major dst lane of the pool into
128-slot chunks with int16-wide deltas at most and 8 escape slots per
chunk.  ``flat_graph.compress_host`` raises when a chunk needs more than 8
escapes past int16 (|delta| > 32767).  For each graph this prints the
directed edge count, the chunk count, the chunks with more than 8 such
escapes, and whether the port's ``compress_host`` raises.  Every graph
is symmetric rMAT (a=0.5, b=c=0.1) from the port's numpy generator; it
runs on the CPU, counts only, in about a minute.
"""
from __future__ import annotations

import json

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import reverse_cuthill_mckee

from repro_torch.core import compressed as cz
from repro_torch.core import flat_graph as fg
from repro_torch.data.rmat import rmat_communities, rmat_edges, symmetrize


def spilling_chunks(edges: np.ndarray, n: int) -> tuple:
    """(chunks, chunks with > OVF_SLOTS int16 escapes) of the pool's dst
    lane, padded as the encoder pads (last dst carried forward)."""
    keys = np.unique((edges[:, 0] << 32) | edges[:, 1])
    cap = fg.fct.grown_capacity(keys.size)
    dst = np.empty(((cap + cz.CHUNK - 1) // cz.CHUNK) * cz.CHUNK, np.int64)
    dst[: keys.size] = keys & 0xFFFFFFFF
    dst[keys.size:] = dst[keys.size - 1]
    rows = dst.reshape(-1, cz.CHUNK)
    esc16 = (np.abs(np.diff(rows, axis=1)) > 32767).sum(axis=1)
    return rows.shape[0], int((esc16 > cz.OVF_SLOTS).sum())


def raises(edges: np.ndarray, n: int) -> bool:
    try:
        fg.compress_host(fg.from_edges(n, edges, device="cpu"))
    except ValueError:
        return True
    return False


def relabel(edges: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Vertex ``order[i]`` becomes vertex i."""
    new_id = np.empty_like(order)
    new_id[order] = np.arange(order.size)
    return new_id[edges]


def main() -> None:
    graphs = []
    for log_n in (14, 15, 16, 18):
        graphs.append((f"rMAT 2^{log_n}, 8 draws/vertex", 1 << log_n,
                       symmetrize(rmat_edges(log_n, 8 << log_n, seed=1))))
    for d in (32, 64):
        graphs.append((f"rMAT 2^16, {d} draws/vertex", 1 << 16,
                       symmetrize(rmat_edges(16, d << 16, seed=1))))
    e16 = graphs[2][2]
    deg = np.bincount(e16[:, 0], minlength=1 << 16)
    graphs.append(("rMAT 2^16 relabelled by degree", 1 << 16,
                   relabel(e16, np.argsort(-deg, kind="stable"))))
    adj = csr_matrix((np.ones(len(e16)), (e16[:, 0], e16[:, 1])), shape=(1 << 16, 1 << 16))
    graphs.append(("rMAT 2^16 relabelled by RCM", 1 << 16,
                   relabel(e16, reverse_cuthill_mckee(adj, symmetric_mode=True).astype(np.int64))))
    comm = rmat_communities(15, 16, 8, seed=10)
    graphs.append(("16 disjoint rMAT communities of 2^15", 16 << 15, comm))
    rng = np.random.default_rng(2)
    pick = rng.choice(len(comm), len(comm) // 100, replace=False)
    rewired = comm.copy()
    rewired[pick, 1] = rng.integers(0, 16 << 15, pick.size)
    graphs.append(("the same, 1% of edges rewired across communities", 16 << 15,
                   symmetrize(rewired)))
    for name, n, edges in graphs:
        chunks, spill = spilling_chunks(edges, n)
        print(json.dumps({"graph": name, "directed_edges": int(len(edges)), "chunks": chunks,
                          "chunks_over_8_int16_escapes": spill,
                          "compress_host_raises": raises(edges, n)}), flush=True)


if __name__ == "__main__":
    main()
