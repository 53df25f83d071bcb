"""Distribution: fault tolerance for training runs (counterpart of
``repro/dist/fault_tolerance.py``), the sharding rules (``shardings``,
counterpart of ``repro/dist/shardings.py``) that the cell builders, the
dry run and training across ranks read, and ``spmd``, the layouts that
run the cells' programs on DTensors (GSPMD's part in the reference):
with values on real ranks, or counted on meta tensors by the dry run.
Real ranks start with ``launch.mesh.init_ranks`` and lay a ``(d, m)``
("data", "model") mesh with ``launch.mesh.rank_mesh``;
``train.train_step.make_train_step(mesh=, specs=)`` trains ZeRO-1 on a
``(k, 1)`` mesh and tensor-parallel on any model axis above 1; decode
and ``serve.decode.generate`` run on parameters laid out by
``spmd.distribute`` (flash decode on a kv-head-sharded cache launches on
each rank's heads); the checkpoints re-shard onto any ``(d, m)`` mesh
(``checkpoint.save(specs=)``, ``restore(mesh=, target_specs=)``).  Open
in ROADMAP item 16: the GNN cells with node-sharded arrays and the
stream query cell with values, flash decode on a sequence-sharded cache,
and a four-GPU run."""
