"""Device time (kernels, copies, memsets; overlaps counted once) inside
each publish span, averaged over the window's publishes."""
from bench import trace as T


def read(run, name):
    tr = run["trace"]
    if tr is None:
        return None
    spans = T.spans_named(tr, "publish")
    union = T.busy_union(tr)
    if not spans or not union:
        return None
    return sum(T.covered(union, a, b) for a, b in spans) / len(spans) / 1e3
