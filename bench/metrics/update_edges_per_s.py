"""Directed keys inserted plus deleted over the whole window (a batch's
distinct keys), from the first publish's hand-over to the last one's
completion."""


def read(run, name):
    keys = sum(op["keys"] for op in run["ops"] if op["kind"] in ("insert", "delete"))
    return keys / run["window_s"] if keys and run["window_s"] > 0 else None
