"""Layouts of the device-resident graph: how the benchmark builds a
version, publishes a batch onto it, serves it and reads it back, through
the port's own calls (``bench/layouts/<layout>.py``, named by a
configuration's ``layout``)."""
