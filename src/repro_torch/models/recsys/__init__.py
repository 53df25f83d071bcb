"""Recommender models (counterpart of ``repro/models/recsys``): DCN-v2 and
its embedding tables."""
