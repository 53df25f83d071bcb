#!/usr/bin/env python3
"""How often a promotion that lags the writer leaves the incremental path.

Runs the body of the reference's
``tests/test_result_cache.py::test_carry_forward_keeps_hot_entry_warm_across_publishes``
(a hot BFS entry, five publishes back to back, then one promotion
barrier) ``--runs`` times on the reference's service and on the port's
(``device="cpu"``), and counts the runs whose promotions recomputed in
full (``promoted_incremental == 0``, the reference test's failure) and
the (anchor stamp, current stamp) pairs each promotion pass carried
across.  On the CPU:

    JAX_PLATFORMS=cpu PYTHONPATH=src python scripts/carry_forward_race.py --runs 20
"""
from __future__ import annotations

import argparse
import collections
import json

import numpy as np


def one_run(stream, svc, cache_cls, passes: list) -> dict:
    orig = cache_cls.carry_forward

    def spy(self, stream_, v_old, v_new, backend, *a, **kw):
        passes.append((v_old.stamp, v_new.stamp))
        return orig(self, stream_, v_old, v_new, backend, *a, **kw)

    cache_cls.carry_forward = spy
    try:
        with svc:
            svc.query("bfs", source=3, timeout=30)
            svc.query("bfs", source=3, timeout=30)  # hot
            for _ in range(5):
                stream.insert_edges(np.array([[7, 11]]))
            svc.flush_promotions(timeout=30)
            t = svc.submit("bfs", source=3)
            t.result(timeout=30)
            cache = svc.stats()["cache"]
    finally:
        cache_cls.carry_forward = orig
    return {"cached": t.cached, "incremental": cache["promoted_incremental"],
            "full": cache["promoted_full"]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args()

    from repro.core import graph as jG
    from repro.core.streaming import AspenStream as JaxStream
    from repro.serve.graph import GraphQueryService as JaxService
    from repro.serve.graph import result_cache as jrc
    from repro_torch.core import graph as tG
    from repro_torch.core.streaming import AspenStream
    from repro_torch.data.rmat import rmat_edges, symmetrize
    from repro_torch.serve.graph import GraphQueryService
    from repro_torch.serve.graph import result_cache as trc

    edges = symmetrize(rmat_edges(8, 2000, seed=11))
    makers = {
        "reference": (lambda: JaxStream(jG.build_graph(256, edges)),
                      lambda s: JaxService(s, backend="numpy", max_batch=8), jrc.ResultCache),
        "port": (lambda: AspenStream(tG.build_graph(256, edges), device="cpu"),
                 lambda s: GraphQueryService(s, backend="numpy", max_batch=8), trc.ResultCache),
    }
    for who, (make_stream, make_service, cache_cls) in makers.items():
        full_only, hops = 0, collections.Counter()
        for _ in range(args.runs):
            passes: list = []
            stream = make_stream()
            res = one_run(stream, make_service(stream), cache_cls, passes)
            full_only += res["incremental"] == 0
            hops.update(f"{a}->{b}" for a, b in passes)
        print(json.dumps({"service": who, "runs": args.runs,
                          "runs_without_an_incremental_promotion": full_only,
                          "promotion_passes": dict(sorted(hops.items()))}), flush=True)


if __name__ == "__main__":
    main()
