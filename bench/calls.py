"""The work of each kernel call in a traced window, from its operands' shapes.

In a traced run the benchmark wraps the port's kernel wrappers (the
chunked decode and the segment sums) for the length of the window, and
records what each call that reaches the card had to read and write.  A
wrapper is found by its module and name at call time; the wrapped call
is the program's own, unchanged.  Counts that need the device (wide
chunks, valid edges) are queued as device reductions and read after the
window, so the window takes no extra host sync.
"""
from __future__ import annotations

import torch

from . import peaks
from .reference import codec

DECODE = ("delta_decode_chunked", "delta_decode_chunked_adaptive")
SEGSUM = ("segment_sum_sorted", "segment_sum_weighted_sorted", "segment_sum_sorted_chunked",
          "segment_sum_weighted_chunked", "segment_sum_sorted_chunked_adaptive",
          "segment_sum_weighted_chunked_adaptive")


class CallLog:
    def __init__(self):
        self.calls = []  # (family, kernel, work thunk -> (bytes, operations))
        self._undo = []
        self._decoded = {}  # the last stream's dst lane, decoded by the benchmark

    def install(self) -> None:
        from repro_torch.kernels import delta_decode, segment_reduce

        for mod, names in ((delta_decode, DECODE), (segment_reduce, SEGSUM)):
            for name in names:
                orig = getattr(mod, name)
                setattr(mod, name, self._wrap(name, orig))
                self._undo.append((mod, name, orig))

    def uninstall(self) -> None:
        for mod, name, orig in reversed(self._undo):
            setattr(mod, name, orig)
        self._undo = []

    def _wrap(self, name, orig):
        def call(*args, **kw):
            out = orig(*args, **kw)
            if out.is_cuda:
                family = "decode" if name in DECODE else "segsum"
                self.calls.append((family, name, self._work(name, args)))
            return out
        return call

    def work(self, family: str) -> list:
        """(bytes, operations) of each recorded call of ``family``."""
        return [thunk() for fam, _, thunk in self.calls if fam == family]

    def _lane(self, stream):
        """The dst lane of a stream, decoded once per stream (by pointer)."""
        key = tuple(t.data_ptr() if torch.is_tensor(t) else None for t in stream)
        if key not in self._decoded:
            self._decoded = {key: codec.decode(*stream)}
        return self._decoded[key]

    def _work(self, name: str, args):
        if name in DECODE:
            if name == "delta_decode_chunked":
                anchors, deltas, ovf_pos, _ = args
                wide_n = None
            else:
                anchors, deltas, hi, wide, ovf_pos, _ = args
                wide_n = wide.sum()
            (R, L), K = deltas.shape, ovf_pos.shape[1]
            lane = deltas.numel() * deltas.element_size()
            return lambda: peaks.chunked_decode_work(
                R, K, L, lane, wide_n is not None, 0 if wide_n is None else int(wide_n))
        weighted = "weighted" in name
        if "chunked" not in name:
            dst, msg, n_out = (args[0], args[2], args[3]) if weighted else args[:3]
            e_valid = (dst < n_out).sum()
            D = msg.shape[1]
            return lambda: peaks.segsum_work(int(e_valid), n_out, D, weighted)
        if "adaptive" in name:
            anchors, deltas, hi, wide, ovf_pos, ovf_add = args[:6]
            rest = args[6:]
        else:
            anchors, deltas, ovf_pos, ovf_add = args[:4]
            hi = wide = None
            rest = args[4:]
        msg, n_out = (rest[1], rest[2]) if weighted else (rest[0], rest[1])
        D = msg.shape[1]
        n_wide = None if wide is None else wide.sum()
        stream = (anchors, deltas, ovf_pos, ovf_add, hi, wide)

        def thunk():
            dst = self._lane(stream)
            e_valid = int(((dst >= 0) & (dst < n_out)).sum())
            nw = 0 if n_wide is None else int(n_wide)
            nbytes = peaks.stream_bytes(anchors, deltas, ovf_pos, ovf_add, wide, nw)
            return peaks.chunked_segsum_work(nbytes, e_valid, n_out, D, weighted)
        return thunk
