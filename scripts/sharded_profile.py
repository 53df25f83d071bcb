#!/usr/bin/env python3
"""Where the sharded engine's query time goes, beside the flat engine's.

Draws ``chip_smoke.py``'s scale graph (rMAT, 2^``--log-n`` vertices, 2^25
draws, symmetrized, on the card), builds the flat ``TorchEngine`` and a
``ShardedEngine`` of ``--shards`` rows over the same pool, and for
``bfs_batch`` over 16 sources and connected components on each engine
prints one JSON line: the wall time of one warm call, the device time
``torch.profiler`` saw in another, and the ops with the most device
time.  It located the sharded engine's costs that PERF.md §6
reports.  Needs one GPU:

    python3 scripts/sharded_profile.py --log-n 22 --shards 8
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=22)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--top", type=int, default=8)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import flat_graph as fg
    from repro_torch.core.traversal import ShardedEngine, TorchEngine, sharded_graph_of_flat
    from repro_torch.core.traversal import algorithms as talg
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("sharded_profile: no CUDA device", file=sys.stderr)
        return 2
    _build.build_all()
    n = 1 << args.log_n
    edges = cs.rmat_symmetric_device(args.log_n, 2**25, seed=2)
    g = fg.from_edges(n, edges, device="cuda")
    del edges
    engines = {"flat": TorchEngine(g), "sharded": ShardedEngine(sharded_graph_of_flat(g, args.shards))}
    rng = np.random.default_rng(0)
    srcs = rng.choice(np.flatnonzero(engines["flat"].degrees.cpu().numpy() > 0), 16, replace=False)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for tag, eng in engines.items():
        queries = {"bfs_batch16": lambda: eng.bfs_batch(srcs),
                   "cc": lambda: talg.connected_components(eng)}
        for qname, q in queries.items():
            q()
            torch.cuda.synchronize()
            t = time.perf_counter()
            q()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            with torch.profiler.profile(activities=acts) as prof:
                q()
                torch.cuda.synchronize()
            evs = prof.key_averages()
            device = [e for e in evs if str(getattr(e, "device_type", "")).endswith("CUDA")]
            top = sorted(evs, key=lambda e: -cs.device_us(e))[: args.top]
            print(json.dumps({
                "engine": tag, "query": qname, "n_shards": args.shards if tag == "sharded" else 1,
                "wall_s": wall, "device_ms": sum(cs.device_us(e) for e in device) / 1e3,
                "top_ops_ms": [[e.key[:60], cs.device_us(e) / 1e3, e.count] for e in top],
            }), flush=True)
    print(json.dumps({"peak_bytes": torch.cuda.max_memory_allocated(),
                      "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
