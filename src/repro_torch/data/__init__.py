"""Synthetic inputs (counterpart of ``repro/data``): graphs, and the
token and recsys batches."""
