"""Serving layer.

``repro_torch.serve.decode`` — batched prefill + decode for the
transformer models, the counterpart of ``repro/serve/decode.py``.  The
graph-query service (``repro/serve/graph``) comes with ROADMAP item 11.
"""
