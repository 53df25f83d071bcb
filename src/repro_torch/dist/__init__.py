"""Distribution: fault tolerance for training runs (counterpart of
``repro/dist/fault_tolerance.py``) and the sharding rules (``shardings``,
counterpart of ``repro/dist/shardings.py``) that the cell builders and the
dry run read; ranks across GPUs that hold the shards are ROADMAP item 16."""
