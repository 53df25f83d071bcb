"""Published peaks and the least time of a kernel's work.

The peaks are NVIDIA's data sheet for the H100 SXM part (dense rates):
3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores, at
the card's full 700 W; a card set below that runs slower, so every
roofline share is printed beside the card's ``power.limit``.

The work functions are frozen copies of the port's kernel-table rule
(``chip_smoke.py``: ``bound``, ``chunked_bound``,
``chunked_decode_bound``): each input read once, each output written
once, over HBM; the adds (and multiplies) over the float32 peak.  One
change against ``chunked_bound``: the hi plane counts the rows that wide
chunks use, as the decode's bound does, not its spare rows.
"""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "f32_flop_per_s": 67e12},
}


def peak_for(kind: str):
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``),
    or None for a card the table does not hold."""
    return PEAKS.get(kind)


def bound_ms(nbytes: float, flops: float, peak: dict) -> float:
    return 1e3 * max(nbytes / peak["hbm_bytes_per_s"], flops / peak["f32_flop_per_s"])


def segsum_work(e_valid: int, n_out: int, D: int, weighted: bool):
    """(bytes, operations) of a segment sum over a raw int32 dst lane."""
    nbytes = e_valid * (4 + 4 * D + (4 if weighted else 0)) + n_out * 4 * D
    return nbytes, e_valid * D * (2 if weighted else 1)


def chunked_segsum_work(stream_bytes: int, e_valid: int, n_out: int, D: int, weighted: bool):
    """(bytes, operations) of a segment sum whose dst lane is read
    chunk-compressed (``stream_bytes`` of it)."""
    nbytes = stream_bytes + e_valid * (4 * D + (4 if weighted else 0)) + n_out * 4 * D
    return nbytes, e_valid * D * (2 if weighted else 1)


def chunked_decode_work(R: int, K: int, L: int, lane_bytes: int, adaptive: bool, n_wide: int):
    """(bytes, operations) of a chunked decode of R rows of L slots: the
    lane, the hi rows wide chunks use, per row the anchor and the escape
    table (adaptive: the wide tag too), and 4 B per id written."""
    per_row = 4 + 8 * K + (1 if adaptive else 0)
    nbytes = lane_bytes + (n_wide * L if adaptive else 0) + per_row * R + 4 * R * L
    return nbytes, R * (L + K)


def stream_bytes(anchors, deltas, ovf_pos, ovf_add, wide=None, n_wide: int = 0) -> int:
    """Bytes a kernel must read of a chunked stream: every array but the
    hi plane, and of the hi plane the rows that wide chunks use."""
    arrays = [anchors, deltas, ovf_pos, ovf_add] + ([wide] if wide is not None else [])
    return sum(t.numel() * t.element_size() for t in arrays) + n_wide * deltas.shape[-1]
