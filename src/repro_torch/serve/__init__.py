"""Serving layer.

``repro_torch.serve.decode`` — batched prefill + decode for the
transformer models, the counterpart of ``repro/serve/decode.py``.

``repro_torch.serve.graph`` — the multi-tenant graph-query service over
a live ``AspenStream``, the counterpart of ``repro/serve/graph``:
per-kind query lanes with deadline-based flush, weighted-fair tenant
admission, snapshot-pinned sessions and a delta-aware result cache.
"""
