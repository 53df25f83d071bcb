"""Models on the port (counterpart of ``repro/models``): the dense LMs,
the GNNs and DCN-v2."""
