"""Core of the port: host C-tree (numpy copies), device pool, streaming.

Counterpart of ``repro/core``.
"""
