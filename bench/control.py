"""Run a cell with its control in the program's place (``bench/controls.py``).

    python3 -m bench.control --workload <cell> --seed <n> --seconds <s> [--device cuda]

Prints the compared numbers beside their limits and one JSON line with
``correct``; a sound check reads ``correct`` false here.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from bench import harness
    from bench.controls import Control

    bm = harness.load_benchmark(ROOT)
    out = harness.run_cell(bm, args.workload, args.seed, args.seconds, False,
                           device=args.device, system=Control())
    for name, (val, lim) in out["checks"].items():
        print(f"check {name} {val!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps({"workload": args.workload, "seed": args.seed, "control": True,
                      "correct": out["result"]["correct"],
                      "checks": out["result"]["checks"]}, default=harness.json_default),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
