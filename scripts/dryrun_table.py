#!/usr/bin/env python3
"""Summarise dry-run JSON lines (``python -m repro_torch.launch.dryrun
--out f.jsonl``) as one markdown table: a row per (arch, shape), each
mesh's ok flag, dominant roofline term, per-device TFLOPs, GB moved,
collective GB, useful fraction, memory-model GiB (argument GiB where a
cell has no model), the views it resharded and the gathers and scatters
it ran masked on a sharded dim, and the run's seconds.

    python3 scripts/dryrun_table.py build/dryrun/*.jsonl
"""
import json
import sys
from collections import defaultdict


def main(paths):
    rows = defaultdict(dict)
    order = []
    for path in paths:
        for line in open(path):
            r = json.loads(line)
            key = (r["arch"], r["shape"])
            if key not in rows:
                order.append(key)
            rows[key][r["mesh"]] = r
    print("| arch | shape | mesh | ok | dominant | TFLOP/dev | GB/dev | coll GB/dev "
          "| useful | mem GiB/dev | resharded views | masked ops | run s |")
    print("| --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- | --- |")
    for key in order:
        for mesh in ("16x16", "2x16x16"):
            r = rows[key].get(mesh)
            if r is None:
                continue
            if not r["ok"]:
                print(f"| {key[0]} | {key[1]} | {mesh} | FAIL: {r['error'][:60]} |"
                      " | | | | | | | | |")
                continue
            mem = r["mem_model"]["total"] if r["mem_model"] else r["mem_argument_bytes"]
            views = ", ".join(f"{k} {v}" for k, v in sorted(r["resharded_views"].items()))
            masked = ", ".join(f"{k} {v}" for k, v in sorted(r["masked_local_ops"].items()))
            print(f"| {key[0]} | {key[1]} | {mesh} | ok | {r['dominant']} "
                  f"| {r['flops_per_dev'] / 1e12:.4g} | {r['bytes_per_dev'] / 1e9:.4g} "
                  f"| {r['collective_bytes_per_dev'] / 1e9:.4g} "
                  f"| {r['useful_compute_frac']:.3f} | {mem / 2**30:.3g} "
                  f"| {views or '-'} | {masked or '-'} | {r['run_s']} |")


if __name__ == "__main__":
    main(sys.argv[1:])
