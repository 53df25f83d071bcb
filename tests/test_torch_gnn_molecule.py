"""SchNet and GraphCast on the port against the reference: the molecule
batches, the multimesh, ``GraphBatch``'s ``edge_attr`` and ``graph_ids``,
both models' forward and loss, three train steps of each, and their
train states through checkpoints in both directions.

Both packages get the same numpy inputs and the reference's parameters
(its ``init`` draws, carried across with ``params_from_numpy``).
``molecule_batch`` and ``build_multimesh`` are bit-identical.  Float32
tolerance: rtol 1e-5, atol 1e-5 * max|reference| for outputs and
losses; train steps as in ``tests/test_torch_train_step.py`` (every
parameter and moment to rtol 1e-4 after each of three steps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import graphcast as jgc_cfg
from repro.configs import schnet as jsch_cfg
from repro.data import pipeline as jpipe
from repro.models.gnn import common as jcommon
from repro.models.gnn import graphcast as jgc
from repro.models.gnn import schnet as jsch
from repro.optim import adamw as jadamw
from repro.train import train_step as jTS
from repro_torch import _tree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import graphcast as tgc_cfg
from repro_torch.configs import schnet as tsch_cfg
from repro_torch.data import pipeline as tpipe
from repro_torch.models import layers as tL
from repro_torch.models.gnn import common as tcommon
from repro_torch.models.gnn import graphcast as tgc
from repro_torch.models.gnn import schnet as tsch
from repro_torch.optim import adamw as tadamw
from repro_torch.train import train_step as tTS
from test_torch_checkpoint import assert_bits_equal, port_template
from test_torch_train_step import run_both

CPU = "cpu"


def assert_close(got, want, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale, err_msg=what)


def carry(jp):
    return tL.params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)


FIELDS = ("x", "src", "dst", "edge_mask", "node_mask", "edge_attr", "graph_ids")


def molecule_fields(seed, step, n_mols, d_feat=16):
    """A ``molecule_batch`` as GraphBatch fields (numpy), with its targets."""
    mb = jpipe.molecule_batch(seed, step, n_mols, d_feat=d_feat)
    n = mb["x"].shape[0]
    return {"x": mb["x"], "src": mb["src"].astype(np.int32), "dst": mb["dst"].astype(np.int32),
            "edge_mask": np.ones(mb["src"].shape, bool), "node_mask": np.ones(n, bool),
            "edge_attr": mb["dist"][:, None], "graph_ids": mb["graph_ids"],
            "targets": mb["targets"]}


def graphs(fields):
    """The same graph as each package's GraphBatch."""
    jb = jcommon.GraphBatch(**{k: jnp.asarray(fields[k]) for k in FIELDS if k in fields})
    tb = tcommon.GraphBatch(**{k: torch.from_numpy(np.array(fields[k]))
                               for k in FIELDS if k in fields})
    return jb, tb


def schnet_params(cfg, d_in, seed=0):
    jp = jsch.init(jax.random.PRNGKey(seed), d_in, cfg.d_hidden, cfg.n_layers, cfg.n_rbf,
                   cfg.n_classes)
    return jp, carry(jp)


def graphcast_params(cfg, d_in, d_edge_in=4, seed=0):
    jp = jgc.init(jax.random.PRNGKey(seed), d_in, cfg.d_hidden, cfg.n_layers, cfg.n_classes,
                  d_edge_in)
    return jp, carry(jp)


# -- data ----------------------------------------------------------------------


@pytest.mark.parametrize("seed,step,n_mols,atoms,edges,d_feat",
                         [(0, 0, 4, 30, 64, 16), (3, 7, 128, 30, 64, 16), (1, 2, 5, 9, 20, 3)])
def test_molecule_batch_bit_identical(seed, step, n_mols, atoms, edges, d_feat):
    got = tpipe.molecule_batch(seed, step, n_mols, atoms, edges, d_feat)
    want = jpipe.molecule_batch(seed, step, n_mols, atoms, edges, d_feat)
    assert got.keys() == want.keys() and got["n_mols"] == want["n_mols"] == n_mols
    for k in want:
        if k != "n_mols":
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["src"] // atoms == got["graph_ids"][got["src"]]).all()


@pytest.mark.parametrize("r", [0, 1, 2, 3])
def test_build_multimesh_bit_identical(r):
    got, want = tgc.build_multimesh(r), jgc.build_multimesh(r)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert int(got.max()) + 1 == 10 * 4 ** r + 2


def test_batch_from_edges_carries_edge_attr():
    rng = np.random.default_rng(4)
    edges = rng.integers(0, 20, (50, 2))
    x = rng.standard_normal((20, 3)).astype(np.float32)
    ea = rng.random((50, 2)) * 5
    want = jcommon.batch_from_edges(20, edges, x, edge_capacity=64, edge_attr=ea)
    got = tcommon.batch_from_edges(20, edges, x, edge_capacity=64, edge_attr=ea, device=CPU)
    for name in ("x", "src", "dst", "edge_mask", "node_mask", "edge_attr"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert got.edge_attr.dtype == torch.float32 and got.graph_ids is None
    assert tcommon.batch_from_edges(20, edges, x, device=CPU).edge_attr is None


@pytest.mark.parametrize("n,batched", [(30, 0), (30, 3), (31, 4), (128, 128)])
def test_random_batch_graph_ids_match_reference(n, batched):
    got = tcommon.random_batch(torch.Generator().manual_seed(0), n, 40, 2, batched=batched,
                               device=CPU)
    want = jcommon.random_batch(jax.random.PRNGKey(0), n, 40, 2, batched=batched)
    if not batched:
        assert got.graph_ids is None and want.graph_ids is None
        return
    assert got.graph_ids.dtype == torch.int64
    np.testing.assert_array_equal(got.graph_ids.numpy(), np.asarray(want.graph_ids))


# -- SchNet --------------------------------------------------------------------


def test_rbf_and_shifted_softplus_match_reference():
    d = np.linspace(-1, 12, 97).astype(np.float32)
    assert_close(tsch.rbf_expand(torch.from_numpy(d), 30, 10.0),
                 jsch.rbf_expand(jnp.asarray(d), 30, 10.0), "rbf")
    x = np.linspace(-60, 60, 241).astype(np.float32)  # holds 0 exactly
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tsch.shifted_softplus(xt)
    assert_close(y, jsch.shifted_softplus(jnp.asarray(x)), "shifted softplus")
    (grad,) = torch.autograd.grad(y.sum(), xt)
    assert_close(grad, jax.vmap(jax.grad(jsch.shifted_softplus))(jnp.asarray(x)),
                 "its gradient (1/2 at 0)")


@pytest.mark.parametrize("which", ["REDUCED", "FULL"])
def test_schnet_forward_and_loss_match_reference(which):
    """Per-atom outputs, the per-molecule readout and the loss on a
    molecule batch (8 molecules; FULL: 300 RBF, d_hidden 64)."""
    cfg = getattr(jsch_cfg, which)
    assert getattr(tsch_cfg, which) == tsch_cfg.GNNConfig(**cfg.__dict__)
    f = molecule_fields(2, 1, 8)
    jb, tb = graphs(f)
    jp, tp = schnet_params(cfg, 16)
    atoms_t, atoms_j = tsch.forward(tp, tb), jsch.forward(jp, jb)
    assert_close(atoms_t, atoms_j, "atom outputs")
    assert_close(tsch.readout_per_molecule(atoms_t, tb.graph_ids, 8, tb.node_mask),
                 jsch.readout_per_molecule(atoms_j, jb.graph_ids, 8, jb.node_mask), "readout")
    assert_close(tsch.loss_fn(tp, tb, torch.from_numpy(f["targets"]), 8),
                 jsch.loss_fn(jp, jb, jnp.asarray(f["targets"]), 8), "loss")


def test_schnet_needs_distances():
    f = molecule_fields(0, 0, 2)
    del f["edge_attr"]
    _, tb = graphs(f)
    _, tp = schnet_params(jsch_cfg.REDUCED, 16)
    with pytest.raises(ValueError, match="edge_attr"):
        tsch.forward(tp, tb)


def test_schnet_init_layout_matches_reference():
    cfg = tsch_cfg.FULL
    tp = tsch.init(torch.Generator().manual_seed(0), 16, cfg.d_hidden, cfg.n_layers, cfg.n_rbf,
                   cfg.n_classes, device=CPU)
    jp, _ = schnet_params(jsch_cfg.FULL, 16)
    assert [p for p, _ in _tree.flatten_with_paths(tp)] == jckpt._flatten_with_paths(jp)[0]
    for t, j in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32


# -- GraphCast -----------------------------------------------------------------


def multimesh_fields(r, d_in, seed, edge_attr):
    e = tgc.build_multimesh(r)
    n = int(e.max()) + 1
    rng = np.random.default_rng(seed)
    f = {"x": rng.standard_normal((n, d_in)).astype(np.float32),
         "src": e[:, 0].astype(np.int32), "dst": e[:, 1].astype(np.int32),
         "edge_mask": np.ones(len(e), bool), "node_mask": np.ones(n, bool)}
    if edge_attr:
        f["edge_attr"] = rng.standard_normal((len(e), 4)).astype(np.float32)
    return f


def random_fields(edge_attr, seed=5):
    """The port's ``random_batch`` (a masked-off tail of edges and nodes
    set here), as numpy fields for both packages."""
    b = tcommon.random_batch(torch.Generator().manual_seed(seed), 50, 300, 8, device=CPU)
    f = {k: getattr(b, k).numpy().copy() for k in ("x", "src", "dst", "edge_mask", "node_mask")}
    f["edge_mask"][-40:] = False
    f["node_mask"][-5:] = False
    if edge_attr:
        f["edge_attr"] = np.random.default_rng(seed).standard_normal((300, 4)).astype(np.float32)
    return f


@pytest.mark.parametrize("graph", ["multimesh1", "random"])
@pytest.mark.parametrize("edge_attr", [False, True])
def test_graphcast_forward_and_loss_match_reference(graph, edge_attr):
    """With edge features given, and without (the structural features
    from degrees), on the level-1 multimesh and on a random batch."""
    cfg = jgc_cfg.REDUCED
    assert tgc_cfg.REDUCED == tgc_cfg.GNNConfig(**cfg.__dict__)
    f = (multimesh_fields(1, cfg.n_vars, 6, edge_attr) if graph == "multimesh1"
         else random_fields(edge_attr))
    d_in = f["x"].shape[1]
    jb, tb = graphs(f)
    jp, tp = graphcast_params(cfg, d_in)
    assert_close(tgc.forward(tp, tb), jgc.forward(jp, jb), "forward")
    targets = np.random.default_rng(7).standard_normal((f["x"].shape[0], cfg.n_classes))
    targets = targets.astype(np.float32)
    assert_close(tgc.loss_fn(tp, tb, torch.from_numpy(targets)),
                 jgc.loss_fn(jp, jb, jnp.asarray(targets)), "loss")


def test_graphcast_full_width_layer_matches_reference():
    """FULL's widths (d_hidden 512, 227 variables) at two layers on the
    level-1 multimesh."""
    full = jgc_cfg.FULL
    f = multimesh_fields(1, full.n_vars, 8, False)
    jb, tb = graphs(f)
    jp = jgc.init(jax.random.PRNGKey(3), full.n_vars, full.d_hidden, 2, full.n_classes)
    assert_close(tgc.forward(carry(jp), tb), jgc.forward(jp, jb), "forward")


def test_graphcast_init_layout_matches_reference():
    cfg = tgc_cfg.REDUCED
    tp = tgc.init(torch.Generator().manual_seed(0), cfg.n_vars, cfg.d_hidden, cfg.n_layers,
                  cfg.n_classes, device=CPU)
    jp, _ = graphcast_params(jgc_cfg.REDUCED, cfg.n_vars)
    assert [p for p, _ in _tree.flatten_with_paths(tp)] == jckpt._flatten_with_paths(jp)[0]
    for t, j in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32


# -- training and checkpoints --------------------------------------------------


def bind(loss_of, package):
    """A family loss over a batch that carries its graph's fields, as a
    float32 scalar: the reference's SchNet loss is float64 (its
    ``rbf_expand`` draws float64 centres under x64, ROADMAP §3)."""
    def f(params, b):
        graph = package.GraphBatch(**{k: b[k] for k in FIELDS if k in b})
        loss = loss_of(params, {"graph": graph, "targets": b["targets"]})
        return loss.astype(jnp.float32) if package is jcommon else loss
    return f


def schnet_case(n_mols=6):
    """``schnet_loss`` over a new molecule batch each step."""
    jp, _ = schnet_params(jsch_cfg.REDUCED, 16, seed=1)

    def batches(step):
        return molecule_fields(4, step, n_mols)

    return (bind(jTS.schnet_loss(n_mols), jcommon), bind(tTS.schnet_loss(n_mols), tcommon), jp,
            batches)


def graphcast_case(edge_attr=False):
    """``graphcast_loss`` on the level-1 multimesh, new targets each step."""
    cfg = jgc_cfg.REDUCED
    f = multimesh_fields(1, cfg.n_vars, 9, edge_attr)
    jp, _ = graphcast_params(cfg, cfg.n_vars, seed=2)

    def batches(step):
        r = np.random.default_rng(200 + step)
        targets = r.standard_normal((f["x"].shape[0], cfg.n_classes)).astype(np.float32)
        return {**f, "targets": targets}

    return (bind(jTS.graphcast_loss(), jcommon), bind(tTS.graphcast_loss(), tcommon), jp,
            batches)


CASES = {"schnet": schnet_case, "graphcast": graphcast_case,
         "graphcast_edge_attr": lambda: graphcast_case(True)}


@pytest.mark.parametrize("family", list(CASES))
def test_train_steps_match_reference(family):
    ts = run_both(CASES[family]())
    assert int(ts.opt.step) == 3


def reference_state(family, n_steps=2):
    jloss, _, jp, batches = CASES[family]()
    step = jax.jit(jTS.make_train_step(jloss, jadamw.wsd_schedule(1, 10, 2, 1e-3)))
    state = jTS.init_state(jp)
    for s in range(n_steps):
        state, _ = step(state, jax.tree.map(jnp.asarray, batches(s)))
    return state


@pytest.mark.parametrize("family", ["schnet", "graphcast"])
def test_checkpoints_cross_the_packages(family, tmp_path):
    """The list-of-dict leaf paths (``interactions.0.filter``,
    ``layers.1.ln_e``) written by either package restore in the other, bit
    for bit."""
    js = reference_state(family)
    jckpt.save(str(tmp_path / "ref"), 2, js)
    step, ts = ckpt.restore(str(tmp_path / "ref"), device=CPU, template=port_template(js))
    assert step == 2
    tflat = _tree.flatten_with_paths(ts)
    jpaths, jleaves, _ = jckpt._flatten_with_paths(js)
    assert [p for p, _ in tflat] == jpaths
    nested = "['interactions']/[0]/['filter']" if family == "schnet" else "['layers']/[1]/['ln_e']"
    assert any(nested in p for p in jpaths), jpaths[:5]
    for (path, t), j in zip(tflat, jleaves):
        assert_bits_equal(t, np.asarray(j), path)
    ckpt.save(str(tmp_path / "port"), 2, ts)
    template = jTS.init_state(jax.tree.map(jnp.zeros_like, js.params))
    step, back = jckpt.restore(str(tmp_path / "port"), template=template)
    assert step == 2
    for (path, t), r in zip(tflat, jax.tree.leaves(back)):
        assert_bits_equal(t, np.asarray(r), path)


# -- on the card ---------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run: python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["schnet", "graphcast"])
def test_cuda_train_steps_match_cpu(family, cuda):
    """Three REDUCED steps on the card and on the CPU from the same state
    and batches: loss to rtol 1e-5, every leaf to rtol 1e-4 (TF32 off)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    _, tloss, jp, batches = CASES[family]()
    step = tTS.make_train_step(tloss, tadamw.wsd_schedule(1, 10, 5, 3e-3))
    cpu = tTS.init_state(carry(jp))
    gpu = _tree.tree_map(lambda x: x.to(cuda), cpu)
    for s in range(3):
        b = batches(s)
        cpu, cm = step(cpu, _tree.tree_map(torch.from_numpy, b))
        gpu, gm = step(gpu, _tree.tree_map(lambda x: torch.from_numpy(x).to(cuda), b))
        np.testing.assert_allclose(float(gm["loss"]), float(cm["loss"]), rtol=1e-5)
        for (path, g), c in zip(_tree.flatten_with_paths(gpu), _tree.leaves(cpu)):
            scale = max(float(c.abs().max()), 1e-30)
            np.testing.assert_allclose(g.cpu().numpy(), c.numpy(), rtol=1e-4, atol=1e-4 * scale,
                                       err_msg=f"step {s}: {path}")
