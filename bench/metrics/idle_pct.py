"""Share of the traced window in which no kernel, copy or memset ran on
the device (``idle_pct.update`` in the update cells, ``idle_pct.bfs`` and
``idle_pct.pagerank`` in the query cells, split as ``queries_per_s``)."""
from bench import trace as T


def read(run, name):
    tr = run["trace"]
    if tr is None or not tr.device or T.window_s(tr) <= 0:
        return None
    return 100.0 * (1.0 - T.busy_s(tr) / T.window_s(tr))
