"""Distribution: fault tolerance for training runs (counterpart of
``repro/dist/fault_tolerance.py``) and the sharding rules (``shardings``,
counterpart of ``repro/dist/shardings.py``) that the cell builders and the
dry run read.  Real ranks start with ``launch.mesh.init_ranks``; training
across them (ZeRO-1 on a ``DeviceMesh``, re-sharded checkpoints) is
ROADMAP item 16's open half."""
