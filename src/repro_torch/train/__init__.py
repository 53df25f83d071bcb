"""Training steps (counterpart of ``repro/train``)."""
