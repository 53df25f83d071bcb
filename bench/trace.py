"""Spans from the benchmark's own files, and the device trace of a window.

In a traced run (``--trace 1``) the measured window runs under
``torch.profiler`` and every span is a ``record_function`` named
``bench.<name>``; otherwise a span costs nothing.  After the window the
profiler's Chrome trace is written to a temporary file, read back into
plain intervals (microseconds on one clock for host and device) and
deleted.  Device activity is every kernel, copy and memset.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
from typing import NamedTuple

import torch

PREFIX = "bench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160  # a device op's name in the breakdown (C++ template names run to kilobytes)


class Trace(NamedTuple):
    window: tuple  # (start, end) of the window span, us
    device: list  # (name, cat, start, end) of each device activity in the window
    spans: list  # (name, start, end) of each benchmark span in the window


class Tracer:
    def __init__(self, enabled: bool, cuda: bool):
        self.enabled = enabled
        self.cuda = cuda
        self._prof = None

    def span(self, name: str):
        if self._prof is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)

    def start(self) -> None:
        if not self.enabled:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()

    def stop(self):
        """Ends the profile; the window's ``Trace``, or None when not tracing."""
        if self._prof is None:
            return None
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            os.unlink(path)
        return parse(events)


def parse(doc) -> Trace:
    """A ``Trace`` from a Chrome trace (a dict with ``traceEvents`` or a list)."""
    events = doc.get("traceEvents", []) if isinstance(doc, dict) else doc
    device, spans = [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        cat = str(ev.get("cat", "")).lower()
        name = str(ev.get("name", ""))
        t0 = float(ev["ts"])
        t1 = t0 + float(ev["dur"])
        if cat in DEVICE_CATS:
            device.append((name, cat, t0, t1))
        elif cat == "user_annotation" and name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], t0, t1))
    wins = [s for s in spans if s[0] == "window"]
    if wins:
        window = (wins[0][1], wins[0][2])
    else:  # no window span: the whole trace
        ts = [d[2] for d in device] + [s[1] for s in spans]
        te = [d[3] for d in device] + [s[2] for s in spans]
        window = (min(ts, default=0.0), max(te, default=0.0))
    lo, hi = window
    device = [(n, c, max(a, lo), min(b, hi)) for n, c, a, b in device if b > lo and a < hi]
    spans = [s for s in spans if s[2] > lo and s[1] < hi]
    return Trace(window, sorted(device, key=lambda d: d[2]), spans)


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(union: list, lo: float, hi: float) -> float:
    """Length of [lo, hi] that the disjoint ``union`` covers."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in union)


def busy_union(tr: Trace, cats=DEVICE_CATS) -> list:
    return merged((a, b) for _, c, a, b in tr.device if c in cats)


def window_s(tr: Trace) -> float:
    return (tr.window[1] - tr.window[0]) / 1e6


def busy_s(tr: Trace) -> float:
    return covered(busy_union(tr), *tr.window) / 1e6


def spans_named(tr: Trace, name: str) -> list:
    return [(a, b) for n, a, b in tr.spans if n == name]


def host_segments(tr: Trace) -> list:
    """The window cut into (start, end, name) pieces, each named by the
    innermost benchmark span the host was in ("window" outside any)."""
    lo, hi = tr.window
    out, stack, t = [], [], lo

    def emit(a, b, name):
        if b > a:
            out.append((a, b, name))

    for a, neg_b, name in sorted((a, -b, n) for n, a, b in tr.spans if n != "window"):
        while stack and stack[-1][0] <= a:
            end, nm = stack.pop()
            emit(t, end, nm)
            t = max(t, end)
        emit(t, a, stack[-1][1] if stack else "window")
        t = max(t, a)
        stack.append((-neg_b, name))
    while stack:
        end, nm = stack.pop()
        emit(t, end, nm)
        t = max(t, end)
    emit(t, hi, "window")
    return out


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the device's idle
    time in the window summed by the span the host was in."""
    ops = {}
    for name, _, a, b in tr.device:
        name = name[:NAME_CHARS]
        ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
    lo, hi = tr.window
    gaps, t = [], lo
    for a, b in busy_union(tr) + [[hi, hi]]:
        if a > t:
            gaps.append((t, min(a, hi)))
        t = max(t, b)
    idle, i, segs = {}, 0, host_segments(tr)
    for a, b in gaps:
        while i < len(segs) and segs[i][1] <= a:
            i += 1
        j = i
        while j < len(segs) and segs[j][0] < b:
            sa, sb, name = segs[j]
            idle[name] = idle.get(name, 0.0) + max(0.0, min(b, sb) - max(a, sa)) / 1e6
            j += 1
    rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
