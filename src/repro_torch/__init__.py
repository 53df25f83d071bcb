"""repro_torch: the Aspen graph-streaming system on PyTorch and CUDA.

Counterpart of ``repro/__init__.py``.  The package mirrors ``repro``
module for module (``repro_torch/core/X.py`` answers to
``repro/core/X.py``) and imports neither ``jax`` nor ``repro``.

There is no x64 switch: packed edge keys are ``torch.int64`` and ids,
offsets and counts ``torch.int32``, the reference's dtypes.  Every entry
point takes a ``device`` argument; ``None`` means ``"cuda"`` and raises
``RuntimeError`` when no GPU is present (``_device.resolve``) — nothing
falls back to the CPU unless the caller asks for it.
"""
from ._device import resolve as resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device", "__version__"]
