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
``spmd.distribute`` (flash decode launches on each rank's kv heads, or
on its block of a sequence-sharded cache, the blocks' outputs combined
by their log-sum-exps); the GNN cells train with their batches laid out
by ``launch.cells.gnn_batch_spec_tree`` (``make_train_step(batch_specs=)``,
nodes over ``model`` for ``ogb_products``), and the aspen-stream cells
run on lanes sharded over every mesh axis; the checkpoints re-shard onto
any ``(d, m)`` mesh (``checkpoint.save(specs=)``, ``restore(mesh=,
target_specs=)``).  Open in ROADMAP item 16: a four-GPU run."""
