"""Checkpoints with atomic commit (counterpart of ``repro/checkpoint``)."""
