"""Synthetic graph inputs (counterpart of ``repro/data``)."""
