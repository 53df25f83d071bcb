#!/usr/bin/env python3
"""How long a publish holds the interpreter lock away from other threads.

The query service's threads need the interpreter lock between every
eager torch op, and its writer thread publishes through the host C-tree
(pure Python).  This script builds the stream phase's graph (rMAT at
``--log-n``, 2,000,000 draws at 2^18, scaled with n; the
``make_update_stream`` rows at 10,000 a batch), then publishes insert
batches while a ticker thread sleeps zero seconds in a loop: a gap
between two ticks is time in which the ticker could not get the lock.
It prints, per publish, the publish time, the longest gap, the time lost
in gaps over 10 ms, and the cyclic collector's passes over 10 ms (from
``gc.callbacks``); then the same after ``gc.freeze()`` moves the
built graph out of the collector's view.  Host work only: the device
mirror is kept on ``--device``.

    PYTHONPATH=src python scripts/publish_gil_probe.py --log-n 18 --device cpu
"""
from __future__ import annotations

import argparse
import gc
import json
import threading
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-n", type=int, default=18)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--publishes", type=int, default=2)
    args = ap.parse_args()

    from repro_torch.core import graph as G
    from repro_torch.core import streaming as st
    from repro_torch.data.rmat import rmat_edges, symmetrize

    n = 2**args.log_n
    draws = 2_000_000 * n // 2**18
    E0 = symmetrize(rmat_edges(args.log_n, draws, seed=1))
    batch = 10_000
    base, updates = st.make_update_stream(E0, 2 * args.publishes * batch, seed=1)
    t0 = time.perf_counter()
    stream = st.AspenStream(G.build_graph(n, base), device=args.device)
    print(json.dumps({"n": n, "edges": int(base.shape[0]), "device": args.device,
                      "build_s": time.perf_counter() - t0,
                      "gc_tracked_objects": len(gc.get_objects())}), flush=True)

    passes = []

    def on_gc(phase, info):
        if phase == "start":
            on_gc.t = time.perf_counter()
        else:
            passes.append((info["generation"], time.perf_counter() - on_gc.t))

    gc.callbacks.append(on_gc)
    j = 0
    for frozen in (False, True):
        if frozen:
            gc.freeze()
        for _ in range(args.publishes):
            rows = updates[j * batch:(j + 1) * batch]
            j += 1
            gaps, stop = [], threading.Event()

            def ticker():
                last = time.perf_counter()
                while not stop.is_set():
                    time.sleep(0)
                    now = time.perf_counter()
                    gaps.append(now - last)
                    last = now

            th = threading.Thread(target=ticker)
            passes.clear()
            th.start()
            t0 = time.perf_counter()
            stream.insert_edges(rows[rows[:, 2] == 0, :2])
            publish_s = time.perf_counter() - t0
            stop.set()
            th.join()
            g = np.asarray(gaps)
            print(json.dumps({
                "gc_frozen": frozen, "insert_rows": int((rows[:, 2] == 0).sum()),
                "publish_s": publish_s, "max_gap_s": float(g.max()),
                "gaps_over_10ms_s": float(g[g > 0.01].sum()),
                "gc_passes_over_10ms": [[gen, round(s, 4)] for gen, s in passes if s > 0.01],
            }), flush=True)
    gc.callbacks.remove(on_gc)


if __name__ == "__main__":
    main()
