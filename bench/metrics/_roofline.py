"""A kernel family's share of its roofline over a traced window: the
least time of the work of every call the window made (``bench.peaks``)
over the device time of the family's kernels, in percent.  Nothing to
read without calls, without device time, or on a card the peak table
does not hold."""
from bench import peaks


def share(run, family: str, kernels: tuple):
    peak = peaks.peak_for(run.get("device_kind", ""))
    work = run.get(f"{family}_work") or []
    tr = run["trace"]
    if peak is None or not work or tr is None:
        return None
    device_ms = sum(b - a for name, cat, a, b in tr.device
                    if cat == "kernel" and any(k in name for k in kernels)) / 1e3
    if device_ms <= 0:
        return None
    return 100.0 * sum(peaks.bound_ms(nb, fl, peak) for nb, fl in work) / device_ms
