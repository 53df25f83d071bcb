#!/usr/bin/env python3
"""The query service's throughput beside a writer, by interpreter switch
interval, and the card's busy share in each load window.

``chip_smoke.py``'s ``graph_serve`` phase serves 24 client threads far
fewer answers a second beside the update writer than alone (PERF.md §5).
The writer's host work (the C-tree insert, pure Python) holds the
interpreter lock, and every eager torch op of a query returns into
Python and waits for it: a query of some hundreds of ops waits up to
one switch interval (5 ms by default) per op.  This script runs the
phase's two load windows (clients alone, then beside the writer; the
phase's subscriptions and cache on/off skipped) on the stream phase's
graph (2^18 vertices, ~3.9 M edges, one weighted batch) once per switch
interval in ``--intervals``, in turns, ``--rounds`` times, and once more
under ``torch.profiler`` at the default interval to read the card's
busy share (union of kernel intervals over each window's wall time).
One JSON line per run.  Needs one GPU:

    python3 scripts/serve_switch_ab.py --intervals 0.005,0.0005 --rounds 2
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def busy_share(prof, lo_s: float, hi_s: float) -> float | None:
    """Share of [lo_s, hi_s) (seconds after the trace's start, the clock of
    the profiler's event times) in which some kernel ran on the card;
    None when the trace holds no kernel."""
    from torch.autograd import DeviceType

    iv = sorted((e.time_range.start, e.time_range.end)
                for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not iv:
        return None
    lo, hi, busy, cur = lo_s * 1e6, hi_s * 1e6, 0.0, None
    for a, b in iv:
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
    if cur is not None:
        busy += cur[1] - cur[0]
    return busy / (hi - lo)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--intervals", default="0.005,0.0005")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.core import graph as G
    from repro_torch.core import streaming as st
    from repro_torch.data.rmat import rmat_edges, symmetrize
    from repro_torch.kernels import _build

    if not torch.cuda.is_available():
        print("serve_switch_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"device": smi}), flush=True)
    _build.build_all()
    E0 = symmetrize(rmat_edges(18, 2_000_000, seed=1))
    base, updates = st.make_update_stream(E0, 60_000, seed=1)
    stream = st.AspenStream(G.build_graph(2**18, base), device="cuda")
    w = np.random.default_rng(0).integers(1, 10, size=10_000).astype(np.float64)
    stream.insert_edges(updates[40_000:50_000, :2], weights=w)

    cs.serve_cache_on_off = lambda stream: None
    cs.serve_subscriptions = lambda *a: None
    captured = []
    cs.emit = captured.append
    keys = ("qps", "qps_by_kind", "miss_p50_s", "miss_p99_s", "deadline_miss_pct",
            "mean_batch_per_flush", "publishes", "writer_updates_per_s")
    default = sys.getswitchinterval()
    intervals = [float(x) for x in args.intervals.split(",")]
    runs = [(x, False) for _ in range(args.rounds) for x in intervals] + [(default, True)]
    for interval, profile in runs:
        sys.setswitchinterval(interval)
        try:
            t0 = time.perf_counter()
            if profile:
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    t_prof = time.perf_counter()
                    t_call = time.perf_counter()
                    cs.phase_graph_serve(stream)
                torch.cuda.synchronize()
            else:
                cs.phase_graph_serve(stream)
        finally:
            sys.setswitchinterval(default)
        out = captured.pop()
        row = {"switch_interval_s": interval, "profiled": profile,
               "run_s": time.perf_counter() - t0}
        for win in ("quiet", "live"):
            row[win] = {k: out[win][k] for k in keys}
            if profile:  # the window's offset from the phase's start, moved to the trace's
                lo = out[win]["at_s"] + (t_call - t_prof)
                row[win]["device_busy_share"] = busy_share(prof, lo, lo + out[win]["s"])
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
