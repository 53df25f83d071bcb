"""Optimizer (counterpart of ``repro/optim``): AdamW over parameter trees."""
