"""Graph neural networks over the streaming store (counterpart of ``repro/models/gnn``)."""
