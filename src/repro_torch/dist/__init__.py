"""Fault tolerance for training runs (counterpart of ``repro/dist/fault_tolerance.py``);
the sharding rules come with ROADMAP item 14, the ranks with item 16."""
