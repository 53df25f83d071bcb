"""Model configurations (counterpart of ``repro/configs``): the GNN part."""
