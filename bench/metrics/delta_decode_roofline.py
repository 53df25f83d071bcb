"""The chunked decode kernels' share of their roofline (rows 8-9 of the
port's kernel table: ``delta_decode_chunked`` and its adaptive form,
whose two launches both count)."""
from bench.metrics._roofline import share

KERNELS = ("chunked_decode_kernel", "tile_prefix_kernel")


def read(run, name):
    return share(run, "decode", KERNELS)
