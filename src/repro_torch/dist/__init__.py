"""Distribution: fault tolerance for training runs (counterpart of
``repro/dist/fault_tolerance.py``) and the sharding rules (``shardings``,
counterpart of ``repro/dist/shardings.py``) that the cell builders, the
dry run and training across ranks read.  Real ranks start with
``launch.mesh.init_ranks``; ``train.train_step.make_train_step(mesh=,
specs=)`` trains data-parallel with ZeRO-1 on a ``(k, 1)`` mesh, and the
checkpoints re-shard (``checkpoint.save(specs=)``, ``restore(mesh=,
target_specs=)``).  The model-axis layouts as value-computing code are
ROADMAP item 16's open remainder."""
