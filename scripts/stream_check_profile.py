"""Time the host side of one ``compressed_stream`` check, two ways.

``chip_smoke.py``'s compressed_stream phase holds every published
version against the numpy engine.  This script builds that phase's
stream (8 rMAT communities of 2^15 vertices, one insert batch and one
weighted batch of 10,000 updates) with its mirror on the CPU, then times
the host work of one check:

  tree     the numpy engine on the version's ``FlatSnapshot``, which
           decodes a vertex's chunks from the host tree on every visit
           (the check as it was before ``DecodedSnapshot``);
  decoded  the numpy engine on ``chip_smoke.DecodedSnapshot``: the tree
           decoded once, then sliced.

It prints each part's seconds (rebuild of the flat graph, BFS x16,
PageRank x8, SSSP x4) and fails unless both ways give the same pool
keys, offsets, weights and query answers.  Host-only: no GPU needed.

    PYTHONPATH=src python3 scripts/stream_check_profile.py
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

from chip_smoke import DecodedSnapshot  # noqa: E402
from repro_torch.core import graph as G  # noqa: E402
from repro_torch.core import streaming as st  # noqa: E402
from repro_torch.core.traversal import flat_graph_of  # noqa: E402
from repro_torch.core.traversal.numpy_backend import NumpyEngine  # noqa: E402
from repro_torch.data.rmat import rmat_communities  # noqa: E402


def check(stream, snap, n: int, seed: int):
    """The host side of one check on ``snap``: (seconds per part, results)."""
    rng = np.random.default_rng(seed)
    secs, res = {}, {}

    def part(name, fn):
        t = time.perf_counter()
        res[name] = fn()
        secs[name] = time.perf_counter() - t

    part("rebuild", lambda: flat_graph_of(snap, device="cpu"))
    eng = NumpyEngine(snap)
    srcs = rng.choice(np.flatnonzero(eng.degrees > 0), 16, replace=False)
    resets = rng.random((8, n))
    resets /= resets.sum(1, keepdims=True)
    part("bfs_x16", lambda: stream._serve_kind(eng, "bfs", srcs, {}))
    part("pagerank_x8", lambda: stream._serve_kind(eng, "pagerank", None, {"resets": resets}))
    part("sssp_x4", lambda: stream._serve_kind(eng, "sssp", srcs[:4], {}))
    return secs, res


def main() -> int:
    torch.set_num_threads(4)
    log_c, n_comm, batch = 15, 8, 10_000
    n = n_comm << log_c
    E0 = rmat_communities(log_c, n_comm, 8, seed=10)
    base, updates = st.make_update_stream(E0, 2 * batch, seed=5)
    t = time.perf_counter()
    stream = st.AspenStream(G.build_graph(n, base), compressed=True, device="cpu")
    build_s = time.perf_counter() - t
    rows = updates[:batch]
    stream.insert_edges(rows[rows[:, 2] == 0, :2])
    w = np.random.default_rng(1).integers(1, 10, size=batch).astype(np.float64)
    stream.insert_edges(updates[batch:, :2], weights=w)

    v = stream.acquire()
    try:
        tree = G.flat_snapshot(v.graph)
        t = time.perf_counter()
        decoded = DecodedSnapshot(tree)
        decode_s = time.perf_counter() - t
        tree_s, tree_res = check(stream, tree, n, seed=7)
        dec_s, dec_res = check(stream, decoded, n, seed=7)
    finally:
        stream.release(v)
    a, b = tree_res.pop("rebuild"), dec_res.pop("rebuild")
    same = (torch.equal(a.keys, b.keys) and torch.equal(a.offsets, b.offsets)
            and torch.equal(a.weights, b.weights)
            and all(np.array_equal(tree_res[k], dec_res[k]) for k in tree_res))
    print(json.dumps({
        "n": n, "m": int(a.m), "tree_build_s": build_s,
        "tree": {**tree_s, "total_s": sum(tree_s.values())},
        "decoded": {"decode_s": decode_s, **dec_s, "total_s": decode_s + sum(dec_s.values())},
        "same_answers": same,
    }))
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
