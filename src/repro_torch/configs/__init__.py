"""Model configurations (counterpart of ``repro/configs``): the dense LMs,
the GNNs, DCN-v2 and the paper's own stream configuration."""
