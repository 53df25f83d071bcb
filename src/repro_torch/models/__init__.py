"""Models on the port (counterpart of ``repro/models``): the GNNs so far."""
