"""One run of one benchmark cell on the GPU.

    python3 -m bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the repository root.  Prints the set-up's parts, the card's power
limit, the program's counters and, as the last lines of standard error,
each number the check compared beside its limit; the last line of
standard output is the result.  Exits 2 without a result when CUDA is
missing or has fewer devices than the cell asks for, and 3 when the run
loaded JAX or the JAX package.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "bench"


def _caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(CACHE / "autotune.json")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    CACHE.mkdir(parents=True, exist_ok=True)


def _steady_allocator() -> str:
    """Map every host allocation of 128 KiB or more afresh and unmap it on
    free (glibc's M_MMAP_THRESHOLD, fixed).  Under glibc's default, moving
    threshold, whether the writer's batch arrays (three of 16 MB a
    publish) reuse heap pages or fault in new ones is decided by each
    process's heap layout, and throughput fell into two modes by process;
    fixed, every run pays the program's fresh allocations alike."""
    import ctypes

    try:
        ok = ctypes.CDLL("libc.so.6").mallopt(-3, 128 * 1024)  # M_MMAP_THRESHOLD
    except (OSError, AttributeError) as e:
        return f"allocator unchanged ({type(e).__name__})"
    return "allocator mmap threshold 131072" if ok == 1 else "allocator unchanged (mallopt)"


def _power() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    allocator = _steady_allocator()
    _caches()
    sys.path.insert(0, str(ROOT / "src"))
    from bench import harness

    bm = harness.load_benchmark(ROOT)
    chips = harness.find(bm["workloads"], args.workload, "workload")["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print("card " + _power(), file=sys.stderr, flush=True)
    print(allocator, file=sys.stderr, flush=True)
    out = harness.run_cell(bm, args.workload, args.seed, args.seconds, bool(args.trace),
                           device="cuda", t_process=T_PROCESS)
    banned = harness.banned_modules()
    if banned:
        print(f"the run loaded {', '.join(banned)}: no result", file=sys.stderr)
        return 3
    rec = out["run"]
    print("counters " + json.dumps(rec["counters"]), file=sys.stderr)
    for name, (val, lim) in out["checks"].items():
        ok = lim is not None and val <= lim
        print(f"check {name} {val!r} limit {lim!r} {'ok' if ok else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"], default=harness.json_default), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
