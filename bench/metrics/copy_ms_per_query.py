"""Device time of host-device copies inside query spans, per answered query
(``copy_ms_per_query.bfs`` / ``.pagerank``, split as ``queries_per_s``)."""


def read(run, name):
    tr = run["trace"]
    answers = sum(op.get("answers", 0) for op in run["ops"])
    if tr is None or not answers:
        return None
    spans = [(a, b) for n, a, b in tr.spans if n == "query"]
    copies = [(a, b) for _, cat, a, b in tr.device if cat == "gpu_memcpy"]
    if not copies:
        return None
    total = sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in copies for lo, hi in spans)
    return total / answers / 1e3
