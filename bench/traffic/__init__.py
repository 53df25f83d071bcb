"""Traffic generators: ``bench/traffic/<generator>.py``, named by a mix's
``generator``.  Each has ``prepare(ctx)`` (set-up and warm-up),
``window(ctx, seconds)`` (the measured loop; returns the run's record)
and ``judge(ctx, rec)`` (frees the program's state, then holds what the
window produced against the plain reference: name -> (value, limit)).
A query generator makes its own call into the program on the engine of
``ctx.system`` (the configuration's layout), and keeps beside it the
call its control makes instead, the reference with one guarantee broken
or at a lower precision."""
from __future__ import annotations

import time

import numpy as np


class Reservoir:
    """A uniform sample of k items of a stream of unknown length, drawn
    from a seeded generator (the same seed and count keep the same items)."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, make):
        """Offer the next item; ``make()`` builds it only if it is kept."""
        i = self.seen
        self.seen += 1
        if i < self.k:
            self.items.append(make())
        else:
            j = int(self.rng.integers(0, i + 1))
            if j < self.k:
                self.items[j] = make()


def clock() -> float:
    return time.perf_counter()


def resident_bytes(system, v, m: int) -> tuple:
    """(bytes of the version's own device storages, its edge count)."""
    return sum(t.numel() * t.element_size() for t in system.storages(v)), m


def is_control(system) -> bool:
    """Whether the reference stands in the program's place (``bench.controls``)."""
    return bool(getattr(system, "is_control", False))
