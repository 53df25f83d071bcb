"""Metric readers: ``bench/metrics/<metric>.py`` (or ``<part before the
first dot>.py`` for a split metric), each with ``read(run, name)`` that
returns the metric's value from a run's record, or None when the run has
nothing to read for it.  The record: ``ops`` (each publish or query with
its host times, keys and answers), ``window_s``, ``setup_s``,
``resident`` ((bytes, edges) of versions), ``counters`` (the program's
counters over the window), ``trace`` (``bench.trace.Trace`` in a traced
run), ``decode_work`` / ``segsum_work`` ((bytes, operations) of each
kernel call in a traced window) and ``device_kind``."""
