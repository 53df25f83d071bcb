"""Device resolution for every entry point of the port.

The reference picks its device through JAX's default backend; the port
makes the choice explicit.  ``None`` means ``"cuda"``: the port runs on
the card unless the caller asks for the CPU, and a CUDA request on a
machine without a GPU raises instead of quietly running on the host.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises ``RuntimeError`` for a CUDA device
    when ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: a CUDA device was requested but no GPU is available; "
            "pass device='cpu' to run on the host"
        )
    return dev
