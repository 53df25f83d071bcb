"""The GNN cells and the aspen-stream cells with values across
``torch.distributed`` ranks, against one rank and the reference.

Two spawns of gloo processes on the CPU start at once and neither waits
on the other (``spawn_ranks`` from ``test_torch_ranks.py``, one torch
thread each): 4 ranks on the (2, 2) ("data", "model") mesh and 2 ranks
on (1, 2).  Every rank is given the same seeded numpy inputs, lays them
out by the cells' specs and runs the cells' code; the one-rank answers
(the same code with no mesh) and the reference's come from this process.

GNN cells, every arch at REDUCED width on small seeded graphs (384
nodes, edges padded to 3,072): ``full_graph_sm`` (edges over the data
axis), ``ogb_products`` (nodes, labels and label mask over ``model``
too: ``gnn_batch_specs(shard_nodes=True)``), ``molecule`` (8 molecules
of 30 atoms) and GraphSAGE's sampled ``minibatch_lg`` (8 seeds, fanouts
(5, 3)).  The state is the cells' replicated one (``train_specs("gnn")``)
and the batch is laid out by ``cells.gnn_batch_spec_tree``
(``make_train_step(batch_specs=)``).  Two train steps each, held in the
float32 class of ``test_torch_tp.py``: against one rank rtol 1e-5 (atol
1e-5 * max|leaf|, at least 1e-3 of the summed lr for a parameter), against
the reference's jitted ``make_train_step`` rtol 1e-4 (losses 1e-5).

Stream cells on a 2^14-edge pool over 2^10 vertices, every array of the
cell laid out over all mesh axes as the reference's cells lay it out:
``update_2m`` (``insert_edges`` of a 2^11-edge batch), its overlay
variant (``union_merge`` into an overlay of 8 batches), ``query_bfs``
(``bfs_levels`` to its fixpoint on the lane-sharded ``EngineAux``) and
``decode_pool`` (the cell's segmented decode).  All results are integers:
bit-identical to one rank and to the reference.
"""
import contextlib
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import flat_ctree as jfct
from repro.core import flat_graph as jfg
from repro.core.traversal import jax_backend as jtb
from repro.data import pipeline as jpipe
from repro.models.gnn import common as jcommon
from repro.models.gnn import gcn as jgcn
from repro.models.gnn import graphcast as jgc
from repro.models.gnn import graphsage as jsage
from repro.models.gnn import schnet as jsch
from repro.optim import adamw as jadamw
from repro.train import train_step as jTS
from repro_torch._tree import flatten_with_paths
from repro_torch.configs import registry
from repro_torch.core import flat_ctree as tfct
from repro_torch.core import flat_graph as tfg
from repro_torch.core.traversal import torch_backend as ttb
from repro_torch.dist import shardings as SH
from repro_torch.dist import spmd
from repro_torch.launch import cells
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tL
from repro_torch.models.gnn import common as tcommon
from repro_torch.optim import adamw
from repro_torch.train import train_step as TS

from test_torch_ranks import spawn_ranks
from test_torch_tp import RTOL_ONE, _assert_metrics, _close_leaf
from test_torch_train_step import LR

GNN_ARCHS = ["gcn-cora", "graphsage-reddit", "schnet", "graphcast"]
GNN_SHAPES = ["full_graph_sm", "ogb_products", "molecule"]
GNN_CASES = [(a, s) for a in GNN_ARCHS for s in GNN_SHAPES] + [("graphsage-reddit",
                                                                 "minibatch_lg")]
MESHES = {4: (2, 2), 2: (1, 2)}
STEPS = 2
N_NODES, E_CAP, D_FEAT = 384, 3072, 12
N_MOLS, SAMPLED_B, FANOUT = 8, 8, (5, 3)
STREAM_N, STREAM_CAP, STREAM_BATCH = 2**10, 2**14, 2**11
STREAM_CELLS = ["update_2m", "update_2m_overlay", "query_bfs", "decode_pool"]
DEADLINE_S = 600
F6_N, F6_KEEP = 8159, 13  # a replicated count, and the trues of a sharded mask


# ---------------------------------------------------------------------------
# the inputs, made here from seeds
# ---------------------------------------------------------------------------


def _graph_fields(kind: str, seed: int) -> dict:
    """A GraphBatch's fields (numpy) for a cell of ``kind``: a power-law
    graph padded to ``E_CAP`` edges, or a molecule batch; every cell
    carries edge distances and graph ids (a model that does not read them
    is given a batch without them)."""
    rng = np.random.default_rng(seed)
    if kind == "batched_small":
        mb = jpipe.molecule_batch(seed, 0, N_MOLS, d_feat=D_FEAT)
        n, e = mb["x"].shape[0], mb["src"].shape[0]
        return {"x": mb["x"], "src": mb["src"].astype(np.int32),
                "dst": mb["dst"].astype(np.int32), "edge_mask": np.ones(e, bool),
                "node_mask": np.ones(n, bool), "edge_attr": mb["dist"][:, None],
                "graph_ids": mb["graph_ids"].astype(np.int32), "n_graphs": N_MOLS}
    offsets, nbrs = jpipe.power_law_graph(N_NODES, 1400, seed=seed)
    edges = np.stack([np.repeat(np.arange(N_NODES), np.diff(offsets)), nbrs], 1)
    assert edges.shape[0] <= E_CAP
    x = rng.standard_normal((N_NODES, D_FEAT)).astype(np.float32)
    dist = (rng.random(edges.shape[0]) * 8 + 0.5).astype(np.float32)[:, None]
    b = jcommon.batch_from_edges(N_NODES, edges, x, edge_capacity=E_CAP, edge_attr=dist)
    f = {k: np.array(getattr(b, k)) for k in ("x", "src", "dst", "edge_mask", "node_mask",
                                              "edge_attr")}
    f["node_mask"][N_NODES - 7:] = False  # a few padding nodes, as the cells pad to 512
    f["graph_ids"] = np.zeros(N_NODES, np.int32)
    f["n_graphs"] = 1
    return f


def _params_np(cfg, d_feat: int, seed: int):
    key = jax.random.PRNGKey(seed)
    if cfg.kind == "gcn":
        p = jgcn.init(key, d_feat, cfg.d_hidden, cfg.n_classes, cfg.n_layers)
    elif cfg.kind == "graphsage":
        p = jsage.init(key, d_feat, cfg.d_hidden, cfg.n_classes, cfg.n_layers)
    elif cfg.kind == "schnet":
        p = jsch.init(key, d_feat, cfg.d_hidden, cfg.n_layers, cfg.n_rbf)
    else:
        p = jgc.init(key, d_feat, cfg.d_hidden, cfg.n_layers, cfg.n_classes)
    return jax.tree.map(np.asarray, p)


def gnn_inputs(arch: str, shape_name: str, seed: int) -> dict:
    """Parameters and ``STEPS`` batches (numpy) of one GNN cell."""
    cfg = registry.get(arch).reduced
    kind = registry.GNN_SHAPES[shape_name]["kind"]
    rng = np.random.default_rng(seed + 1000)
    if kind == "sampled":
        offsets, nbrs = jpipe.power_law_graph(300, 1500, seed=seed)
        feats = rng.standard_normal((300, D_FEAT)).astype(np.float32)
        sampler = jpipe.NeighborSampler(offsets, nbrs, feats)
        batches = []
        for s in range(STEPS):
            b = sampler.sample_batch(seed, s, SAMPLED_B, FANOUT)
            batches.append({"x_self": b["x_self"], "neigh_feats": list(b["neigh_feats"]),
                            "neigh_masks": list(b["neigh_masks"]),
                            "labels": (b["seeds"] % cfg.n_classes).astype(np.int32)})
        return {"params": _params_np(cfg, D_FEAT, seed), "batches": batches, "n_graphs": 0}
    f = _graph_fields(kind, seed)
    n_graphs = f.pop("n_graphs")
    batched = kind == "batched_small" or cfg.kind == "schnet"
    graph = {k: v for k, v in f.items()
             if (k != "edge_attr" or cfg.kind == "schnet") and (k != "graph_ids" or batched)}
    n = f["x"].shape[0]
    batches = []
    for s in range(STEPS):
        if cfg.kind == "schnet":
            extra = {"targets": rng.standard_normal(n_graphs).astype(np.float32)}
        elif cfg.kind == "graphcast":
            extra = {"targets": rng.standard_normal((n, cfg.n_classes)).astype(np.float32)}
        else:
            extra = {"labels": rng.integers(0, cfg.n_classes, n).astype(np.int32),
                     "label_mask": rng.random(n) < 0.5}
        batches.append({"graph": graph, **extra})
    return {"params": _params_np(cfg, D_FEAT, seed), "batches": batches, "n_graphs": n_graphs}


def stream_inputs() -> dict:
    """A 2^14-edge pool over 2^10 vertices, a 2^11-edge batch, an overlay
    holding half its capacity, a BFS source and a compressed lane's
    (deltas, anchors, heads)."""
    rng = np.random.default_rng(29)

    def sorted_keys(k, cap):
        keys = np.unique(rng.integers(0, STREAM_N, (k, 2)) @ np.array([1 << 32, 1]))
        out = np.full(cap, np.iinfo(np.int64).max, np.int64)
        out[:len(keys)] = keys
        return out, len(keys)

    pool, m = sorted_keys(STREAM_CAP // 2, STREAM_CAP)
    src = pool[:m] >> 32
    offsets = np.searchsorted(src, np.arange(STREAM_N + 1)).astype(np.int32)
    batch, nb = sorted_keys(STREAM_BATCH - 100, STREAM_BATCH)
    overlay, no = sorted_keys(4 * STREAM_BATCH, 8 * STREAM_BATCH)
    heads = rng.random(STREAM_CAP) < 1 / 64
    heads[0] = True
    deltas = rng.integers(1, 50, STREAM_CAP).astype(np.int64)
    anchors = np.zeros(STREAM_CAP, np.int64)
    chunk = np.cumsum(heads) - 1
    anchors[:] = (rng.integers(0, 1 << 40, int(heads.sum())))[chunk]
    return {"pool": {"offsets": offsets, "keys": pool, "m": np.int32(m)},
            "batch": {"data": batch, "n": np.int32(nb)},
            "overlay": {"data": overlay, "n": np.int32(no)},
            "source": 3, "decode": {"deltas": deltas, "anchors": anchors, "heads": heads}}


def make_inputs() -> dict:
    gnn = {(a, s): gnn_inputs(a, s, seed=i) for i, (a, s) in enumerate(GNN_CASES)}
    return {"gnn": gnn, "stream": stream_inputs()}


# ---------------------------------------------------------------------------
# the cells' code, on a mesh or (mesh None) one rank
# ---------------------------------------------------------------------------


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree))


def _port_batch(b):
    b = _torch(b)
    if "graph" in b:
        b["graph"] = tcommon.GraphBatch(**b["graph"])
    return b


def _port_loss(cfg, shape_name, n_graphs):
    kind = registry.GNN_SHAPES[shape_name]["kind"]
    if kind == "sampled":
        return TS.sage_sampled_loss()
    if cfg.kind == "gcn":
        return TS.gcn_loss(None)
    if cfg.kind == "graphsage":
        return TS.sage_full_loss()
    if cfg.kind == "schnet":
        return TS.schnet_loss(n_graphs)
    return TS.graphcast_loss()


def gnn_case(arch, shape_name, x, mesh) -> dict:
    """Two train steps of one GNN cell: metrics and the logical state."""
    cfg = registry.get(arch).reduced
    params = tL.params_from_numpy(x["params"], device="cpu")
    loss = _port_loss(cfg, shape_name, x["n_graphs"])
    sched = adamw.wsd_schedule(**LR)
    state = TS.init_state(params)
    if mesh is None:
        step = TS.make_train_step(loss, sched)
    else:
        specs = ttrain.train_specs("gnn", cfg, params, mesh)
        b_specs = cells.gnn_batch_spec_tree(cfg, registry.GNN_SHAPES[shape_name], mesh)
        step = TS.make_train_step(loss, sched, mesh=mesh, specs=specs, batch_specs=b_specs)
        state = SH.place(state, specs, mesh)
    metrics = []
    for b in x["batches"]:
        state, m = step(state, _port_batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
    logical = state if mesh is None else SH.gather(state, specs, mesh)
    return {"metrics": metrics,
            "state": {p: t.detach().numpy().copy() for p, t in flatten_with_paths(logical)}}


def _all_axes(mesh):
    return tuple(n for n in mesh.mesh_dim_names if n in ("data", "model"))


def _value(t):
    return (t.full_tensor() if spmd.is_dtensor(t) else t).numpy().copy()


def stream_cases(x, mesh) -> dict:
    """The four stream cells' results, every array laid out over all mesh
    axes (``mesh`` None: one rank, plain tensors)."""
    g = tfg.FlatGraph(**_torch(x["pool"]))
    batch = tfct.FlatCTree(**_torch(x["batch"]))
    overlay = tfct.FlatCTree(**_torch(x["overlay"]))
    dec = _torch(x["decode"])
    aux = ttb.engine_aux(g)
    source = torch.tensor(x["source"], dtype=torch.int32)
    lane = None if mesh is None else SH.P(_all_axes(mesh))
    if mesh is not None:
        g = spmd.distribute(g, tfg.FlatGraph(offsets=SH.P(None), keys=lane, m=SH.P()), mesh)
        bs = tfct.FlatCTree(data=lane, n=SH.P())
        batch, overlay = spmd.distribute(batch, bs, mesh), spmd.distribute(overlay, bs, mesh)
        aux = spmd.distribute(aux, ttb.EngineAux(
            src_c=lane, dst_c=lane, evalid=lane, degrees=SH.P(None), dst_sorted=lane,
            src_by_dst=lane, valid_by_dst=lane, dst_offsets=SH.P(None)), mesh)
        dec = spmd.distribute(dec, {k: lane for k in dec}, mesh)
        source = spmd.distribute(source, SH.P(), mesh)
    with spmd.running() if mesh is not None else contextlib.nullcontext():
        new = tfg.insert_edges(g, batch, out_cap=STREAM_CAP)
        merged = tfct.union_merge(overlay, batch, out_cap=8 * STREAM_BATCH)
        levels = ttb.bfs_levels(g, source, aux)
        decoded = cells._decode_pool_step(dec["deltas"], dec["anchors"], dec["heads"])
        return {"update_2m": [_value(t) for t in (new.offsets, new.keys, new.m)],
                "update_2m_overlay": [_value(merged.data), _value(merged.n)],
                "query_bfs": [_value(levels)],
                "decode_pool": [_value(decoded)]}


def rank_job(inputs) -> dict:
    """What each rank of a spawn computes, on its world's mesh."""
    import torch.distributed as dist

    mesh = mesh_lib.rank_mesh(MESHES[dist.get_world_size()], ("data", "model"), device="cpu")
    out = {"gnn": {c: gnn_case(*c, inputs["gnn"][c], mesh) for c in GNN_CASES},
           "stream": stream_cases(inputs["stream"], mesh)}
    keep = torch.arange(64) < F6_KEEP
    with spmd.running():
        n = spmd.distribute(torch.tensor(F6_N), SH.P(), mesh)
        f6 = n + spmd.distribute(keep, SH.P(_all_axes(mesh)), mesh).sum()
        out["f6"] = int(f6.full_tensor())
    out["host_copied"] = dict(spmd.HOST_COPIED)
    return out


# ---------------------------------------------------------------------------
# the reference's answers
# ---------------------------------------------------------------------------


def _ref_loss(cfg, shape_name, n_graphs):
    kind = registry.GNN_SHAPES[shape_name]["kind"]
    if kind == "sampled":
        return jTS.sage_sampled_loss()
    if cfg.kind == "gcn":
        return jTS.gcn_loss(None)
    if cfg.kind == "graphsage":
        return jTS.sage_full_loss()
    if cfg.kind == "schnet":
        f = jTS.schnet_loss(n_graphs)
        # the reference's SchNet loss is float64 (its RBF centres under x64)
        return lambda p, b: f(p, b).astype(jnp.float32)
    return jTS.graphcast_loss()


def _ref_batch(b):
    b = jax.tree.map(jnp.asarray, b)
    if "graph" in b:
        b["graph"] = jcommon.GraphBatch(**b["graph"])
    return b


def reference(inputs) -> dict:
    out = {"gnn": {}}
    for arch, shape_name in GNN_CASES:
        cfg = registry.get(arch).reduced
        x = inputs["gnn"][arch, shape_name]
        step = jax.jit(jTS.make_train_step(_ref_loss(cfg, shape_name, x["n_graphs"]),
                                           jadamw.wsd_schedule(**LR)))
        st, metrics = jTS.init_state(jax.tree.map(jnp.asarray, x["params"])), []
        for b in x["batches"]:
            st, m = step(st, _ref_batch(b))
            metrics.append({k: float(v) for k, v in m.items()})
        out["gnn"][arch, shape_name] = {"metrics": metrics,
                                        "state": jax.tree.map(np.asarray, st)}
    x = inputs["stream"]
    g = jfg.FlatGraph(**jax.tree.map(jnp.asarray, x["pool"]))
    batch = jfct.FlatCTree(**jax.tree.map(jnp.asarray, x["batch"]))
    overlay = jfct.FlatCTree(**jax.tree.map(jnp.asarray, x["overlay"]))
    new = jfg.insert_edges(g, batch, out_cap=STREAM_CAP, optimized=True)
    merged = jfct.union_merge(overlay, batch, out_cap=8 * STREAM_BATCH)
    levels = jtb.bfs_levels(g, jnp.int32(x["source"]), jtb.engine_aux(g))
    d = x["decode"]
    out["stream"] = {
        "update_2m": [np.asarray(t) for t in (new.offsets, new.keys, new.m)],
        "update_2m_overlay": [np.asarray(merged.data), np.asarray(merged.n)],
        "query_bfs": [np.asarray(levels)],
        "decode_pool": [np.asarray(_ref_decode(d["deltas"], d["anchors"], d["heads"]))],
    }
    return out


def _ref_decode(deltas, anchors_at, head_mask):
    """The reference's decode_pool step (``repro/launch/cells.py``), on
    its jnp arrays."""
    deltas, anchors_at, head_mask = map(jnp.asarray, (deltas, anchors_at, head_mask))
    c = jnp.cumsum(deltas)
    chunk_id = jnp.cumsum(head_mask.astype(jnp.int64)) - head_mask.astype(jnp.int64)
    base = c - deltas
    per_chunk_base = jax.ops.segment_max(jnp.where(head_mask, base, -1), chunk_id,
                                         num_segments=deltas.shape[0])
    return anchors_at[chunk_id] + (c - per_chunk_base[chunk_id])


# ---------------------------------------------------------------------------
# the runs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import concurrent.futures

    root = tmp_path_factory.mktemp("cells_ranks")
    inputs = make_inputs()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        jobs = {w: pool.submit(spawn_ranks, rank_job, w, root, inputs, timeout=DEADLINE_S)
                for w in MESHES}
        ref = reference(inputs)
        one = {"gnn": {c: gnn_case(*c, inputs["gnn"][c], None) for c in GNN_CASES},
               "stream": stream_cases(inputs["stream"], None)}
        res = {MESHES[w]: f.result() for w, f in jobs.items()}
    return {"mesh": res, "one": one, "ref": ref}


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mesh", list(MESHES.values()))
@pytest.mark.parametrize("case", GNN_CASES, ids=[f"{a}-{s}" for a, s in GNN_CASES])
def test_gnn_cell_trains_as_one_rank(runs, case, mesh):
    want = runs["one"]["gnn"][case]
    for r, res in enumerate(runs["mesh"][mesh]):
        got = res["gnn"][case]
        _assert_metrics(got["metrics"], want["metrics"], RTOL_ONE, f"{mesh} rank {r}")
        assert got["state"].keys() == want["state"].keys()
        for p in want["state"]:
            _close_leaf(got["state"][p], want["state"][p], p, RTOL_ONE, f"{mesh} rank {r}")


@pytest.mark.parametrize("mesh", list(MESHES.values()))
@pytest.mark.parametrize("case", GNN_CASES, ids=[f"{a}-{s}" for a, s in GNN_CASES])
def test_gnn_cell_trains_as_the_reference(runs, case, mesh):
    from repro.checkpoint import checkpoint as jckpt

    want = runs["ref"]["gnn"][case]
    got = runs["mesh"][mesh][0]["gnn"][case]
    _assert_metrics(got["metrics"], want["metrics"], 1e-5, f"{mesh}")
    jpaths, jleaves, _ = jckpt._flatten_with_paths(want["state"])
    assert list(got["state"]) == jpaths
    for p, j in zip(jpaths, jleaves):
        _close_leaf(got["state"][p], j, p, 1e-4, f"{mesh}")


@pytest.mark.parametrize("mesh", list(MESHES.values()))
@pytest.mark.parametrize("cell", STREAM_CELLS)
def test_stream_cell_is_bit_identical_to_one_rank_and_the_reference(runs, cell, mesh):
    for want in (runs["one"]["stream"][cell], runs["ref"]["stream"][cell]):
        for r, res in enumerate(runs["mesh"][mesh]):
            got = res["stream"][cell]
            assert len(got) == len(want)
            for a, b in zip(got, want):
                b = np.asarray(b)
                assert a.dtype == b.dtype and a.shape == b.shape, (cell, r)
                np.testing.assert_array_equal(a, b, err_msg=f"{cell} {mesh} rank {r}")


def test_the_cells_shard_what_they_should(runs):
    """The ogb_products cell's nodes, labels and label mask shard over
    ``model`` and its edges over the data axis, the other cells' nodes
    are whole; the one-rank BFS runs several rounds."""
    mesh = types.SimpleNamespace(shape={"data": 2, "model": 2})
    for arch in GNN_ARCHS:
        cfg = registry.get(arch).reduced
        big = cells.gnn_batch_spec_tree(cfg, registry.GNN_SHAPES["ogb_products"], mesh)
        small = cells.gnn_batch_spec_tree(cfg, registry.GNN_SHAPES["full_graph_sm"], mesh)
        assert tuple(big["graph"].x) == ("model", None) and tuple(big["graph"].src) == ("data",)
        assert tuple(small["graph"].x) == (None, None)
        if "labels" in big:
            assert tuple(big["labels"]) == tuple(big["label_mask"]) == ("model",)
    levels = runs["one"]["stream"]["query_bfs"][0]
    assert (levels > 0).sum() > 10 and levels.max() >= 2


def test_f6_a_replicated_integer_beside_a_pending_sum_is_not_divided(runs):
    """F6: ``n + keep.sum()`` with ``keep`` sharded (a count pending its
    all-reduce) once lost up to a rank's remainder of ``n``: DTensor laid
    the replicated ``n`` out as a partial by dividing it over the ranks."""
    for res in runs["mesh"].values():
        for r in res:
            assert r["f6"] == F6_N + F6_KEEP


def test_batch_specs_take_the_batch_whole():
    """A batch laid out by its specs is one graph: ``make_train_step``
    refuses ``n_micro`` slices of it, and specs with no mesh."""
    mesh = types.SimpleNamespace(shape={"data": 1, "model": 2})
    loss, sched = TS.gcn_loss(None), adamw.wsd_schedule(**LR)
    with pytest.raises(ValueError, match="n_micro"):
        TS.make_train_step(loss, sched, n_micro=2, mesh=mesh, batch_specs={})
    with pytest.raises(ValueError, match="n_micro"):
        TS.make_train_step(loss, sched, batch_specs={})


def test_gloo_on_the_cpu_copies_nothing_through_the_host(runs):
    for res in runs["mesh"].values():
        for r in res:
            assert r["host_copied"] == {}
