"""The segment-sum kernels' share of their roofline (rows 1-6 of the
port's kernel table; each call's edge pass and carry fix-up both count)."""
from bench.metrics._roofline import share

KERNELS = ("tile_d1_kernel", "tile_cols_kernel", "fixup_kernel")


def read(run, name):
    return share(run, "segsum", KERNELS)
