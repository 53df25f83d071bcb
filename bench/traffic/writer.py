"""One writer publishing update batches back to back, with no reader.

Set-up draws a ring of ``ring`` distinct batches of ``batch_draws`` rMAT
draws each (the configuration's id layout, communities kept), symmetric,
as host (k, 2) edges, unsorted and with duplicates.  The window inserts batch k mod ring as the k-th insert and,
from insert ``delete_lag`` on, follows each insert with the delete of the
batch inserted ``delete_lag`` inserts before, so the edge count holds
steady.  A publish is timed from the edges handed over on the host to
the new version complete on the device: the program's packing, upload,
device sort and merge.  The window runs on past its
length until the held version (below) has been published over.

Judged: the newest version, and the version after publish h (h drawn
from the seed in ``hold``), held through every later publish; each
against the reference's edge set after that many publishes.
"""
from __future__ import annotations

import gc
import itertools

import numpy as np
import torch

from .. import gen
from ..reference import codec, sets
from . import clock, resident_bytes


def schedule(ring: int, lag: int):
    for k in itertools.count():
        yield "insert", k % ring
        if k >= lag:
            yield "delete", (k - lag) % ring


def prepare(ctx) -> None:
    mix, cfg = ctx.mix, ctx.cfg
    t = clock()
    ctx.ring = [gen.batch_edges(cfg, mix["batch_draws"], ctx.seed, 1 + r, ctx.device)
                for r in range(mix["ring"])]
    ctx.ring_keys = [sets.batch_keys(e, ctx.device).numel() for e in ctx.ring]
    ctx.parts["batches_s"] = clock() - t
    lo, hi = mix["hold"]
    ctx.hold_at = int(np.random.default_rng([ctx.seed, 11]).integers(lo, hi + 1))
    # warm-up: an insert and a delete at each padded batch shape of the ring
    t = clock()
    shapes = {}
    for r, e in enumerate(ctx.ring):
        shapes.setdefault(int(2 ** np.ceil(np.log2(e.shape[0] + 1))), r)
    for r in shapes.values():
        b = ctx.ring[r]
        v1 = ctx.system.publish(ctx.version, "insert", b, ctx.m, ctx.device, ctx.span)
        m1, _ = ctx.system.settle(v1)
        v2 = ctx.system.publish(v1, "delete", b, m1, ctx.device, ctx.span)
        ctx.system.settle(v2)
        del v1, v2
    ctx.parts["warmup_s"] = clock() - t


def window(ctx, seconds: float) -> dict:
    sys_, batches, span = ctx.system, ctx.ring, ctx.span
    v, m = ctx.version, ctx.m
    ops, log, resident = [], [], []
    failed, held = 0, None
    sched = schedule(ctx.mix["ring"], ctx.mix["delete_lag"])
    t_start = clock()
    deadline = t_start + seconds
    while True:
        kind, r = next(sched)
        t0 = clock()
        try:
            with span("publish"):
                new = sys_.publish(v, kind, batches[r], m, ctx.device, span)
                with span("publish.wait"):
                    m_new, spilled = sys_.settle(new)
        except Exception as e:  # noqa: BLE001 - a publish that raises is a failed publish
            ctx.log(f"publish {len(log)} ({kind} {r}) raised {type(e).__name__}: {e}")
            failed += 1
            ops.append({"kind": kind, "keys": 0, "t0": t0, "t1": clock()})
            break
        t1 = clock()
        ops.append({"kind": kind, "keys": ctx.ring_keys[r], "t0": t0, "t1": t1})
        failed += int(spilled)
        v, m = new, m_new
        log.append((kind, r))
        resident.append(resident_bytes(sys_, v, m))
        if len(log) == ctx.hold_at:
            held = v
        if t1 >= deadline and len(log) > ctx.hold_at:
            break
    ctx.version, ctx.held, ctx.log_ops = v, held, log
    return {"t_start": t_start, "t_end": ops[-1]["t1"], "ops": ops, "attempted": len(ops),
            "failed": failed, "resident": resident}


def _errors(judged: dict, want, n: int) -> dict:
    if "stream" in judged:
        judged = dict(judged, dst=codec.decode(*judged["stream"]))
    return sets.pool_errors(judged, want, n)


def judge(ctx, rec: dict) -> dict:
    sys_ = ctx.system
    out = {"newest": sys_.judged(ctx.version)}
    if ctx.held is not None:
        out["held"] = sys_.judged(ctx.held)
    ctx.version = ctx.held = None
    gc.collect()
    if torch.device(ctx.device).type == "cuda":
        torch.cuda.empty_cache()
    base = torch.from_numpy(ctx.keys).to(ctx.device)
    ring = [sets.batch_keys(e, ctx.device) for e in ctx.ring]
    n = ctx.cfg["n"]
    checks = {"failed": (rec["failed"], 0)}
    upto = {"newest": len(ctx.log_ops), "held": ctx.hold_at}
    for tag, judged in out.items():
        want = sets.state_after(base, ring, ctx.log_ops, upto[tag])
        for name, val in _errors(judged, want, n).items():
            checks[f"{tag}.{name}"] = (val, 0)
        del want
    if "held" not in out:
        checks["held.missing"] = (1, 0)
    return checks
