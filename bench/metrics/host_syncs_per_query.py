"""Blocking device-to-host reads of the traversal layer
(``traversal.HOST_SYNCS``) over the window, per answered query."""


def read(run, name):
    answers = sum(op.get("answers", 0) for op in run["ops"])
    return run["counters"]["host_syncs"] / answers if answers else None
