#!/usr/bin/env python3
"""chip_smoke's multi-rank phases alone, on one GPU (~3 min).

    python3 scripts/ranks_phases.py            # from the repo root

Builds the kernels, runs chip_smoke's ``scale`` and ``sharded_scale``
phases (which write the flat engine's answers to
``build/ranks/scale_ref.npz``), then the ``ranks`` and ``moe_shardmap``
phases (their rank children, ``chip_smoke.py --rank-job``), and the
``train`` phase's two smollm-360m steps at B 1 x S 4096.  Prints each
phase's JSON line as chip_smoke does, and each part's wall seconds.
"""
import gc
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("ranks_phases: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = str(cs.TUNE_TABLE)
    cs.TUNE_TABLE.unlink(missing_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cs.phase_env(smi)
    g, aux, _ = cs.phase_scale()
    cs.phase_sharded_scale(g, aux)
    del g, aux
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    procs = cs.start_rank_jobs()
    cs.phase_ranks(procs, t0)
    cs.phase_moe_shardmap(procs, t0)
    cs.emit({"ranks_and_moe_shardmap_s": time.perf_counter() - t0})
    from repro_torch.configs import smollm_360m

    t1 = time.perf_counter()
    cs.emit({"phase": "train_long", "card": smi, **cs.long_seq_run(smollm_360m.FULL),
             "wall_s": time.perf_counter() - t1})
    return 0


if __name__ == "__main__":
    sys.exit(main())
