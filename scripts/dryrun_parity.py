#!/usr/bin/env python3
"""Hold the dry run's counts of two source trees against each other.

Runs ``python -m repro_torch.launch.dryrun --all --include-stream --mesh
both --reduced`` (the 86 REDUCED cells: 43 cells on the 16x16 and the
2x16x16 meshes) once with this checkout's ``src`` and once
with ``--old`` (another checkout's ``src``, e.g. ``git archive <commit>
src | tar -x -C build/old``), both at once, then compares per cell the
FLOPs, bytes and collective bytes per device, the collectives by kind
and by link, the resharded views and the masked ops.  Prints one line
per cell that differs and a JSON summary last; exits 1 on any
difference or failed cell.

    python3 scripts/dryrun_parity.py --old build/old/src
    python3 scripts/dryrun_parity.py --old-jsonl a.jsonl --new-jsonl b.jsonl

A REDUCED pass takes ~3 min of host time a tree; the trees run in two
processes side by side.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KEYS = ("ok", "flops_per_dev", "bytes_per_dev", "collective_bytes_per_dev",
        "collective_kinds", "collective_links", "resharded_views", "masked_local_ops")


def run(src: Path, out: Path) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--include-stream",
           "--mesh", "both", "--reduced", "--out", str(out)]
    env = dict(os.environ, PYTHONPATH=str(src))
    return subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def cells(path: Path) -> dict:
    out = {}
    for line in path.read_text().splitlines():
        r = json.loads(line)
        out[(r["arch"], r["shape"], r["mesh"])] = r
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--old", help="the other tree's src directory")
    ap.add_argument("--old-jsonl", help="the other tree's dry-run lines, already run")
    ap.add_argument("--new-jsonl", help="this tree's dry-run lines, already run")
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        old = Path(args.old_jsonl) if args.old_jsonl else Path(tmp) / "old.jsonl"
        new = Path(args.new_jsonl) if args.new_jsonl else Path(tmp) / "new.jsonl"
        procs = []
        if not args.old_jsonl:
            if not args.old:
                ap.error("--old or --old-jsonl")
            procs.append(run(Path(args.old).resolve(), old))
        if not args.new_jsonl:
            procs.append(run(ROOT / "src", new))
        for p in procs:
            p.wait()
        a, b = cells(old), cells(new)
    differ = []
    for key in sorted(set(a) | set(b)):
        ra, rb = a.get(key), b.get(key)
        if ra is None or rb is None or not (ra["ok"] and rb["ok"]):
            differ.append(key)
            print(f"{'/'.join(key)}: old {ra and ra['ok']} new {rb and rb['ok']}")
            continue
        bad = [k for k in KEYS if ra.get(k) != rb.get(k)]
        if bad:
            differ.append(key)
            print(f"{'/'.join(key)}: " + ", ".join(f"{k} {ra.get(k)} -> {rb.get(k)}"
                                                   for k in bad))
    print(json.dumps({"cells": len(set(a) | set(b)), "old_ok": sum(r["ok"] for r in a.values()),
                      "new_ok": sum(r["ok"] for r in b.values()), "differ": len(differ),
                      "keys": list(KEYS)}))
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
