"""One closed-loop client running single-source BFS on one version, no writer.

Each query is ``traversal.algorithms.bfs_multi`` on one source (the
path ``AspenStream.query_batch`` serves) on the version's engine, built
once at set-up as a stream caches it per version, with the parent array
brought to the host.  Sources are drawn uniformly among vertices
with out-degree > 0; so that every seed sends the same mix of work, the
draws are stratified by whether the source lies in the component of the
highest-degree vertex (a whole-graph traversal) or outside it (a few
rounds): query i comes from outside iff floor((i + 1) f + u) > floor(i f
+ u), with f the share of sources outside and u a seeded phase.

Judged: a sample of ``sample`` answers drawn from the seed, each against
the reference's BFS on the generated graph.  Control: answers from the
reference's BFS on a stale version, the graph without the keys of one
more batch of ``stale_draws`` draws (a query that does not see exactly
its version's edges; a version that far behind gives wrong answers,
where one a few thousand edges behind can still give a valid tree of
the true graph).
"""
from __future__ import annotations

import gc
import math

import numpy as np
import torch

from .. import gen
from ..reference import bfs as rbfs
from . import Reservoir, clock, is_control, resident_bytes


def program_answerer(ctx):
    from repro_torch.core.traversal import algorithms as talg

    eng = ctx.engine = ctx.system.engine(ctx.version)
    return lambda src: talg.bfs_multi(eng, np.array([src]))[0][0]


def control_answerer(ctx):
    cfg = ctx.cfg
    src, dst = gen.rmat_draws(cfg["log_n"], ctx.mix["stale_draws"], gen.sub_seed(ctx.seed, 99),
                              ctx.device, cfg.get("communities", 1), cfg.get("rmat"))
    keys = torch.from_numpy(ctx.keys).to(ctx.device)
    g = ctx.engine = rbfs.Graph(keys[~torch.isin(keys, gen.symmetric_keys(src, dst))], cfg["n"])
    return lambda s: rbfs.parents(g, rbfs.depths(g, s), s).to(torch.int32).cpu().numpy()


def _strata(ctx):
    g = rbfs.Graph(torch.from_numpy(ctx.keys).to(ctx.device), ctx.cfg["n"])
    deg = g.degrees()
    giant = rbfs.depths(g, int(torch.argmax(deg))) >= 0
    inside = torch.nonzero((deg > 0) & giant, as_tuple=True)[0].cpu().numpy()
    outside = torch.nonzero((deg > 0) & ~giant, as_tuple=True)[0].cpu().numpy()
    return inside, outside


def sources(ctx, inside, outside, stream: int):
    rng = np.random.default_rng([ctx.seed, stream])
    f = outside.size / max(1, inside.size + outside.size)
    u = rng.random()
    i = 0
    while True:
        out = math.floor((i + 1) * f + u) > math.floor(i * f + u)
        pool = outside if out and outside.size else inside
        yield int(pool[rng.integers(0, pool.size)])
        i += 1


def prepare(ctx) -> None:
    t = clock()
    inside, outside = _strata(ctx)
    ctx.parts["sources_s"] = clock() - t
    ctx.log(f"sources: {inside.size} in the largest component, {outside.size} outside")
    gc.collect()
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    t = clock()
    ctx.answer = (control_answerer if is_control(ctx.system) else program_answerer)(ctx)
    ctx.parts["engine_s"] = clock() - t
    ctx.sources = sources(ctx, inside, outside, 21)
    t = clock()
    ctx.answer(next(sources(ctx, inside, outside, 22)))
    ctx.parts["warmup_s"] = clock() - t


def window(ctx, seconds: float) -> dict:
    keep = Reservoir(ctx.mix["sample"], np.random.default_rng([ctx.seed, 23]))
    ops, failed = [], 0
    t_start = clock()
    deadline = t_start + seconds
    while True:
        src = next(ctx.sources)
        t0 = clock()
        try:
            with ctx.span("query"):
                par = ctx.answer(src)
        except Exception as e:  # noqa: BLE001 - a query that raises is a failed query
            ctx.log(f"query from {src} raised {type(e).__name__}: {e}")
            failed += 1
            ops.append({"kind": "query", "answers": 0, "t0": t0, "t1": clock()})
            break
        t1 = clock()
        ops.append({"kind": "query", "answers": 1, "t0": t0, "t1": t1})
        keep.offer(lambda: (src, par))
        if t1 >= deadline:
            break
    ctx.sample = keep.items
    return {"t_start": t_start, "t_end": ops[-1]["t1"], "ops": ops, "attempted": len(ops),
            "failed": failed, "resident": [resident_bytes(ctx.system, ctx.version, ctx.m)]}


def judge(ctx, rec: dict) -> dict:
    ctx.answer = ctx.engine = ctx.version = None
    gc.collect()
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    g = rbfs.Graph(torch.from_numpy(ctx.keys).to(ctx.device), ctx.cfg["n"])
    errs = 0
    for src, par in ctx.sample:
        errs += rbfs.parent_errors(g, par, src, rbfs.depths(g, src))
    ctx.log(f"judged {len(ctx.sample)} answers")
    return {"failed": (rec["failed"], 0), "parent_errors": (errs, 0)}
