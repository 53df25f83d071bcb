"""One closed-loop client running personalized PageRank batches, no writer.

Each call is ``traversal.algorithms.pagerank_multi`` on the version's
engine (built once, at set-up) with ``lanes`` one-hot reset rows, their
vertices drawn uniformly among vertices with out-degree > 0, for
``iters`` iterations at ``damping``; the rows go up as one host array
(reused from call to call) and the scores come back to the host.  A call
answers ``lanes`` queries.

Judged: a sample of ``sample`` calls drawn from the seed; each lane's
scores against the reference's float64 power iteration, by the L1
distance of the score vectors (each sums to 1).  Control: the
reference's power iteration in bfloat16, the precision below the
float32 the configuration states for scores.
"""
from __future__ import annotations

import gc

import numpy as np
import torch

from ..reference import bfs as rbfs
from ..reference import pagerank as rpr
from . import Reservoir, clock, is_control, resident_bytes


def program_answerer(ctx):
    from repro_torch.core.traversal import algorithms as talg

    eng = ctx.engine = ctx.system.engine(ctx.version)
    iters, damping = ctx.mix["iters"], ctx.mix["damping"]
    return lambda resets: talg.pagerank_multi(eng, resets, iters=iters, damping=damping)


def control_answerer(ctx):
    g = ctx.engine = rbfs.Graph(torch.from_numpy(ctx.keys).to(ctx.device), ctx.cfg["n"])
    iters, damping = ctx.mix["iters"], ctx.mix["damping"]

    def answer(resets):
        rows = torch.from_numpy(resets).to(ctx.device)
        return torch.stack([rpr.pagerank(g, r, iters, damping, dtype=torch.bfloat16)
                            for r in rows]).float().cpu().numpy()
    return answer


def prepare(ctx) -> None:
    mix = ctx.mix
    deg = np.bincount(ctx.keys >> 32, minlength=ctx.cfg["n"])
    ctx.cand = np.flatnonzero(deg > 0)
    ctx.rng = np.random.default_rng([ctx.seed, 31])
    ctx.resets = np.zeros((mix["lanes"], ctx.cfg["n"]), dtype=np.float32)
    t = clock()
    ctx.answer = (control_answerer if is_control(ctx.system) else program_answerer)(ctx)
    ctx.parts["engine_s"] = clock() - t
    t = clock()
    lanes = ctx.cand[np.random.default_rng([ctx.seed, 32]).integers(0, ctx.cand.size,
                                                                     mix["lanes"])]
    _call(ctx, lanes)
    ctx.parts["warmup_s"] = clock() - t


def _call(ctx, lanes):
    rows = np.arange(lanes.size)
    ctx.resets[rows, lanes] = 1.0
    try:
        return ctx.answer(ctx.resets)
    finally:
        ctx.resets[rows, lanes] = 0.0


def window(ctx, seconds: float) -> dict:
    lanes_n = ctx.mix["lanes"]
    keep = Reservoir(ctx.mix["sample"], np.random.default_rng([ctx.seed, 33]))
    ops, failed = [], 0
    t_start = clock()
    deadline = t_start + seconds
    while True:
        lanes = ctx.cand[ctx.rng.integers(0, ctx.cand.size, lanes_n)]
        t0 = clock()
        try:
            with ctx.span("query"):
                pr = _call(ctx, lanes)
        except Exception as e:  # noqa: BLE001 - a query that raises is a failed query
            ctx.log(f"pagerank call raised {type(e).__name__}: {e}")
            failed += lanes_n
            ops.append({"kind": "query", "answers": 0, "t0": t0, "t1": clock()})
            break
        t1 = clock()
        ops.append({"kind": "query", "answers": lanes_n, "t0": t0, "t1": t1})
        keep.offer(lambda: (lanes, pr))
        if t1 >= deadline:
            break
    ctx.sample = keep.items
    return {"t_start": t_start, "t_end": ops[-1]["t1"], "ops": ops,
            "attempted": lanes_n * len(ops), "failed": failed,
            "resident": [resident_bytes(ctx.system, ctx.version, ctx.m)]}


def judge(ctx, rec: dict) -> dict:
    ctx.answer = ctx.engine = ctx.version = None
    gc.collect()
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    n = ctx.cfg["n"]
    g = rbfs.Graph(torch.from_numpy(ctx.keys).to(ctx.device), n)
    worst, bad = 0.0, 0
    for lanes, pr in ctx.sample:
        for b, v in enumerate(lanes):
            reset = torch.zeros(n, dtype=torch.float64, device=ctx.device)
            reset[int(v)] = 1.0
            want = rpr.pagerank(g, reset, ctx.mix["iters"], ctx.mix["damping"])
            got = torch.from_numpy(np.asarray(pr[b], dtype=np.float64)).to(ctx.device)
            if got.numel() != n or not bool(torch.isfinite(got).all()):
                bad += 1
                continue
            worst = max(worst, float((got - want).abs().sum()))
    ctx.log(f"judged {len(ctx.sample)} calls of {ctx.mix['lanes']} lanes")
    return {"failed": (rec["failed"], 0), "bad_rows": (bad, 0),
            "pagerank_l1": (worst, ctx.mix["limit_l1"])}
