"""Hand-written Hopper kernels of the port and their wrappers.

Counterpart of ``repro/kernels``.  Sources live in ``csrc/`` and are
built with ``nvcc`` for ``sm_90a`` at first use (``_build``); nothing is
compiled when a module here is imported.
"""
