#!/usr/bin/env python3
"""Where a dry-run cell's per-device FLOPs go: run one cell of the port's
dry run (``repro_torch.launch.dryrun.run_cell``) and print its total and
the ops on DTensors that counted the most, each with the global shapes
and placements of its DTensor arguments.

    PYTHONPATH=src python scripts/dryrun_op_flops.py smollm-360m/train_4k [--full] [--multi]

REDUCED configs unless ``--full``; the 16x16 mesh unless ``--multi``.
"""
import collections
import sys

import torch
from torch.distributed.tensor import DTensor

from repro_torch.launch import dryrun


def main(argv):
    arch, shape = argv[0].split("/")
    per_op = collections.Counter()
    on_dtensors = dryrun.CostMode._on_dtensors

    def counted(self, func, args, kwargs):
        before = self.flops
        out = on_dtensors(self, func, args, kwargs)
        if self.flops > before:
            key = (str(func), tuple((tuple(a.shape), "".join(map(str, a.placements)))
                                    for a in args if isinstance(a, DTensor)))
            per_op[key] += self.flops - before
        return out

    dryrun.CostMode._on_dtensors = counted
    res = dryrun.run_cell(arch, shape, "--multi" in argv, reduced="--full" not in argv)
    print(f"total {res['flops_per_dev']:.4g} FLOPs a device (torch {torch.__version__})")
    for key, flops in per_op.most_common(14):
        print(f"{flops:.3e} {key}")


if __name__ == "__main__":
    main(sys.argv[1:])
