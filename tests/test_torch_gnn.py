"""The port's GNN path (sampler, GraphBatch, GraphSAGE, GCN) against the JAX reference.

Both packages get the same numpy inputs and the same weights: the
reference's ``init`` draws them with ``jax.random`` and
``common.params_from_numpy`` carries them across, since torch cannot
reproduce those draws.  On the CPU the port's fanout wrapper runs its
plain version; the reference's ``use_kernel=True`` path runs its Pallas
kernel in interpret mode.

Exactness classes: the power-law graph, the sampler's ids, masks and
gathered features, and ``batch_from_flat_graph``'s edge lanes are
bit-identical (integer work and gathers); aggregations, forwards and
losses hold to rtol 1e-5, atol 1e-5 * max|out| (float32 sums and
products in another order; at FULL widths a logit sums 602 products).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gcn_cora as jgcn_cfg
from repro.configs import graphcast as jgc_cfg
from repro.configs import graphsage_reddit as jsage_cfg
from repro.configs import registry as jreg
from repro.configs import schnet as jsch_cfg
from repro.core import flat_graph as jfg
from repro.data import pipeline as jpipe
from repro.models import layers as jL
from repro.models.gnn import common as jcommon
from repro.models.gnn import gcn as jgcn
from repro.models.gnn import graphsage as jsage
from repro_torch.configs import gcn_cora as tgcn_cfg
from repro_torch.configs import graphcast as tgc_cfg
from repro_torch.configs import graphsage_reddit as tsage_cfg
from repro_torch.configs import registry as treg
from repro_torch.configs import schnet as tsch_cfg
from repro_torch.core import flat_graph as tfg
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import segment_reduce as sr
from repro_torch.models import layers as tL
from repro_torch.models.gnn import common as tcommon
from repro_torch.models.gnn import gcn as tgcn
from repro_torch.models.gnn import graphsage as tsage

CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.array(x))


def assert_close(got, want, what=""):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale, err_msg=what)


def edges_of(offsets, nbrs):
    return np.stack([np.repeat(np.arange(offsets.size - 1), np.diff(offsets)), nbrs], 1)


# ---------------------------------------------------------------------------
# configs, layers
# ---------------------------------------------------------------------------


def test_configs_match_reference():
    assert treg.GNN_SHAPES == jreg.GNN_SHAPES
    for tm, jm in ((tsage_cfg, jsage_cfg), (tgcn_cfg, jgcn_cfg), (tsch_cfg, jsch_cfg),
                   (tgc_cfg, jgc_cfg)):
        for which in ("FULL", "REDUCED"):
            t, j = getattr(tm, which), getattr(jm, which)
            assert [(f, getattr(t, f)) for f in t.__dataclass_fields__] == \
                [(f, getattr(j, f)) for f in j.__dataclass_fields__]
    assert treg.ARCH_IDS == jreg.ARCH_IDS
    for arch in treg.ARCH_IDS:
        spec, ref = treg.get(arch), jreg.get(arch)
        assert (spec.arch_id, spec.family, spec.shapes) == (ref.arch_id, ref.family, ref.shapes)
    with pytest.raises(KeyError):
        treg.get("no-such-arch")


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_reference(masked):
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((33, 41)).astype(np.float32) * 3
    labels = rng.integers(0, 41, 33)
    mask = (rng.random(33) < 0.5).astype(np.float32) if masked else None
    got = tL.cross_entropy(_t(logits), _t(labels), None if mask is None else _t(mask))
    want = jL.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                            None if mask is None else jnp.asarray(mask))
    assert_close(got, want)


def test_normal_draws_from_the_generator():
    a = tL._normal(torch.Generator().manual_seed(3), (50, 7), 0.5, torch.float32, torch.device(CPU))
    b = tL._normal(torch.Generator().manual_seed(3), (50, 7), 0.5, torch.float32, torch.device(CPU))
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert 0.3 < float(a.std()) < 0.7


# ---------------------------------------------------------------------------
# data: power-law graph and the neighbour sampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,m,seed", [(1000, 5000, 0), (2708, 5278, 1), (300, 40, 2)])
def test_power_law_graph_bit_identical(n, m, seed):
    to, tn = tpipe.power_law_graph(n, m, seed)
    jo, jn = jpipe.power_law_graph(n, m, seed)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(tn, jn)
    assert tn.dtype == jn.dtype and to.dtype == jo.dtype


def sampler_pair(n=600, m=3000, d=12, offsets_dtype=np.int64, seed=0):
    offsets, nbrs = jpipe.power_law_graph(n, m, seed)
    offsets = offsets.astype(offsets_dtype)
    feats = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    ref = jpipe.NeighborSampler(offsets, nbrs, feats)
    port = tpipe.NeighborSampler(_t(offsets), _t(nbrs), _t(feats))
    return ref, port


@pytest.mark.parametrize("offsets_dtype", [np.int64, np.int32])
@pytest.mark.parametrize("fanout", [1, 10])
def test_sample_neighbors_ids_and_masks_bit_identical(offsets_dtype, fanout):
    ref, port = sampler_pair(offsets_dtype=offsets_dtype)
    nodes = np.random.default_rng(5).integers(0, ref.n, 200)
    nodes[:20] = np.flatnonzero(np.diff(ref.offsets) == 0)[:1].repeat(20)  # zero-degree nodes
    want_ids, want_mask = ref._sample_neighbors(np.random.default_rng(9), nodes, fanout)
    got_ids, got_mask = port._sample_neighbors(np.random.default_rng(9), _t(nodes), fanout)
    np.testing.assert_array_equal(got_ids.numpy(), want_ids)
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    assert got_ids.dtype == torch.int64 and not want_mask[:20].any()


@pytest.mark.parametrize("offsets_dtype", [np.int64, np.int32])
@pytest.mark.parametrize("B,fanouts,step", [(8, (15, 10), 0), (33, (5, 3), 7), (1, (2, 2), 3)])
def test_sample_batch_bit_identical(offsets_dtype, B, fanouts, step):
    ref, port = sampler_pair(offsets_dtype=offsets_dtype)
    want = ref.sample_batch(4, step, B, fanouts)
    got = port.sample_batch(4, step, B, fanouts)
    np.testing.assert_array_equal(got["seeds"].numpy(), want["seeds"])
    np.testing.assert_array_equal(got["x_self"].numpy(), want["x_self"])
    for k in range(2):
        np.testing.assert_array_equal(got["neigh_feats"][k].numpy(), want["neigh_feats"][k])
        np.testing.assert_array_equal(got["neigh_masks"][k].numpy(), want["neigh_masks"][k])
    ids = port.sample_ids(4, step, B, fanouts)["ids"]
    np.testing.assert_array_equal(port.feats[ids[1]].numpy(), want["neigh_feats"][1])


def test_sampler_reads_the_streaming_store():
    """As ``examples/train_gnn.py`` does: a flat graph is streamed into
    between batches and the sampler reads each new snapshot's CSR."""
    n = 500
    offsets, nbrs = jpipe.power_law_graph(n, 2500, seed=3)
    edges = edges_of(offsets, nbrs)
    jg, tg = jfg.from_edges(n, edges), tfg.from_edges(n, edges, device=CPU)
    feats = np.random.default_rng(0).standard_normal((n, 6)).astype(np.float32)
    rng = np.random.default_rng(1)
    for step in range(3):
        if step:
            new = np.stack([rng.integers(0, n, 64), rng.integers(0, n, 64)], 1)
            jg, tg = jfg.insert_edges_host(jg, new), tfg.insert_edges_host(tg, new)
        ref = jpipe.NeighborSampler(np.asarray(jg.offsets),
                                    np.asarray(jg.keys)[: int(jg.m)] & 0xFFFFFFFF, feats)
        port = tpipe.NeighborSampler(tg.offsets, tg.keys[: int(tg.m)] & 0xFFFFFFFF, _t(feats))
        want, got = ref.sample_batch(0, step, 16, (4, 3)), port.sample_batch(0, step, 16, (4, 3))
        for k in range(2):
            np.testing.assert_array_equal(got["neigh_feats"][k].numpy(), want["neigh_feats"][k])
            np.testing.assert_array_equal(got["neigh_masks"][k].numpy(), want["neigh_masks"][k])


# ---------------------------------------------------------------------------
# GraphBatch and aggregation
# ---------------------------------------------------------------------------


def test_batch_from_flat_graph_bit_identical():
    n = 400
    offsets, nbrs = jpipe.power_law_graph(n, 1500, seed=4)
    edges = edges_of(offsets, nbrs)
    x = np.random.default_rng(0).standard_normal((n, 5)).astype(np.float32)
    jg, tg = jfg.from_edges(n, edges), tfg.from_edges(n, edges, device=CPU)
    assert tg.edge_capacity > int(tg.m)  # pad slots (SENT64 keys) are present
    want = jcommon.batch_from_flat_graph(jg, jnp.asarray(x))
    got = tcommon.batch_from_flat_graph(tg, _t(x))
    for name in ("src", "dst", "edge_mask", "node_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    assert got.src.dtype == torch.int32 and got.dst.dtype == torch.int32
    assert int(got.src[-1]) == n - 1 and int(got.dst[-1]) == n - 1


def test_batch_from_edges_matches_reference():
    rng = np.random.default_rng(3)
    edges = rng.integers(0, 50, (120, 2))
    x = rng.standard_normal((50, 4)).astype(np.float32)
    want = jcommon.batch_from_edges(50, edges, x, edge_capacity=128)
    got = tcommon.batch_from_edges(50, edges, x, edge_capacity=128, device=CPU)
    for name in ("x", "src", "dst", "edge_mask", "node_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))


@pytest.mark.parametrize("op", ["sum", "mean", "max"])
@pytest.mark.parametrize("masked", [False, True])
def test_aggregate_matches_reference(op, masked):
    """Masked edges, and nodes with no edge at all (-inf under max, as
    ``jax.ops.segment_max`` gives) or only masked edges (finfo.min)."""
    rng = np.random.default_rng(8)
    n, E, D = 40, 300, 7
    dst = rng.integers(0, n - 5, E)  # nodes n-5 .. n-1 receive nothing
    msg = rng.standard_normal((E, D)).astype(np.float32)
    mask = rng.random(E) < 0.6 if masked else None
    if masked:
        mask[dst == 3] = False  # node 3: only masked edges
    got = tcommon.aggregate(_t(msg), _t(dst), n, op, None if mask is None else _t(mask))
    want = np.asarray(jcommon.aggregate(jnp.asarray(msg), jnp.asarray(dst), n, op,
                                        None if mask is None else jnp.asarray(mask)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * 4)
    if op == "max":
        assert np.isneginf(got.numpy()[n - 1]).all()
        if masked:
            assert (got.numpy()[3] == np.finfo(np.float32).min).all()


def test_degrees_and_sym_norm_match_reference():
    rng = np.random.default_rng(9)
    edges = rng.integers(0, 60, (200, 2))
    x = np.zeros((60, 1), np.float32)
    jb = jcommon.batch_from_edges(60, edges, x, edge_capacity=256)
    tb = tcommon.batch_from_edges(60, edges, x, edge_capacity=256, device=CPU)
    np.testing.assert_array_equal(tcommon.degrees(tb).numpy(), np.asarray(jcommon.degrees(jb)))
    assert_close(tcommon.sym_norm_coeff(tb), jcommon.sym_norm_coeff(jb))


def test_random_batch_and_params_from_numpy():
    b = tcommon.random_batch(torch.Generator().manual_seed(0), 30, 90, 4, device=CPU)
    assert b.x.shape == (30, 4) and b.n_edges == 90 and b.src.dtype == torch.int32
    assert int(b.src.max()) < 30 and int(b.dst.max()) < 30 and bool(b.edge_mask.all())
    tree = {"layers": [{"w": np.ones((2, 3), np.float32)}], "ws": (np.zeros(4),)}
    got = tcommon.params_from_numpy(tree, device=CPU)
    assert isinstance(got["ws"], tuple) and got["layers"][0]["w"].shape == (2, 3)
    assert got["layers"][0]["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


def sage_params(d_in, d_hidden, n_classes, seed=0):
    jp = jsage.init(jax.random.PRNGKey(seed), d_in, d_hidden, n_classes)
    return jp, tcommon.params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)


def test_graphsage_init_shapes():
    p = tsage.init(torch.Generator().manual_seed(0), 602, 128, 41, device=CPU)
    jp = jsage.init(jax.random.PRNGKey(0), 602, 128, 41)
    for t, j in zip(p["layers"], jp["layers"]):
        for k in ("w_self", "w_neigh"):
            assert tuple(t[k].shape) == j[k].shape and t[k].dtype == torch.float32


@pytest.mark.parametrize("cfg", ["REDUCED", "FULL"])
def test_graphsage_forward_full_matches_reference(cfg):
    c = getattr(tsage_cfg, cfg)
    n, d = 300, 24 if cfg == "REDUCED" else 602
    offsets, nbrs = jpipe.power_law_graph(n, 1200, seed=1)
    edges = edges_of(offsets, nbrs)
    x = np.random.default_rng(1).standard_normal((n, d)).astype(np.float32)
    jp, tp = sage_params(d, c.d_hidden, c.n_classes)
    jb = jcommon.batch_from_edges(n, edges, x, edge_capacity=edges.shape[0] + 17)
    tb = tcommon.batch_from_edges(n, edges, x, edge_capacity=edges.shape[0] + 17, device=CPU)
    assert_close(tsage.forward_full(tp, tb), jsage.forward_full(jp, jb), "forward_full")
    labels = np.random.default_rng(2).integers(0, c.n_classes, n)
    lmask = np.random.default_rng(3).random(n) < 0.3
    assert_close(tsage.loss_fn_full(tp, tb, _t(labels), _t(lmask)),
                 jsage.loss_fn_full(jp, jb, jnp.asarray(labels), jnp.asarray(lmask)))


@pytest.mark.parametrize("cfg,B,fanouts,d", [
    ("REDUCED", 16, (5, 3), 24),
    ("FULL", 8, (15, 10), 602),
])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_graphsage_forward_sampled_matches_reference(cfg, B, fanouts, d, use_kernel):
    c = getattr(tsage_cfg, cfg)
    ref, port = sampler_pair(n=800, m=4000, d=d, seed=2)
    jb = ref.sample_batch(1, 0, B, fanouts)
    tb = port.sample_batch(1, 0, B, fanouts)
    jp, tp = sage_params(d, c.d_hidden, c.n_classes)
    before = sr.LAUNCHES["fanout_aggregate"]
    got = tsage.forward_sampled(tp, tb["x_self"], tb["neigh_feats"], tb["neigh_masks"],
                                use_kernel=use_kernel)
    assert sr.LAUNCHES["fanout_aggregate"] == before  # CPU tensors: plain version
    want = jsage.forward_sampled(jp, jnp.asarray(jb["x_self"]),
                                 [jnp.asarray(f) for f in jb["neigh_feats"]],
                                 [jnp.asarray(m) for m in jb["neigh_masks"]],
                                 use_kernel=use_kernel)
    assert tuple(got.shape) == (B, c.n_classes)
    assert_close(got, want, f"forward_sampled use_kernel={use_kernel}")
    labels = jnp.asarray(np.arange(B) % c.n_classes)
    assert_close(tsage.loss_fn_sampled(tp, tb["x_self"], tb["neigh_feats"], tb["neigh_masks"],
                                       _t(np.asarray(labels))),
                 jsage.loss_fn_sampled(jp, jnp.asarray(jb["x_self"]),
                                       [jnp.asarray(f) for f in jb["neigh_feats"]],
                                       [jnp.asarray(m) for m in jb["neigh_masks"]], labels))


def test_graphsage_sampled_needs_two_layers():
    p = tsage.init(torch.Generator().manual_seed(0), 4, 4, 2, n_layers=3, device=CPU)
    with pytest.raises(ValueError):
        tsage.forward_sampled(p, torch.zeros(1, 4), [torch.zeros(1, 2, 4)] * 2,
                              [torch.ones(1, 2, dtype=torch.bool)] * 2)


@pytest.mark.parametrize("cfg", ["REDUCED", "FULL"])
def test_gcn_forward_matches_reference(cfg):
    """gcn-cora at its FULL widths (d_feat 1433, hidden 16, 7 classes) on
    a Cora-sized power-law graph read from the streaming store."""
    c = getattr(tgcn_cfg, cfg)
    n = 2708 if cfg == "FULL" else 200
    d = 1433 if cfg == "FULL" else 12
    offsets, nbrs = jpipe.power_law_graph(n, n * 2, seed=3)
    edges = edges_of(offsets, nbrs)
    x = np.random.default_rng(4).standard_normal((n, d)).astype(np.float32)
    jg, tg = jfg.from_edges(n, edges), tfg.from_edges(n, edges, device=CPU)
    jb = jcommon.batch_from_flat_graph(jg, jnp.asarray(x))
    tb = tcommon.batch_from_flat_graph(tg, _t(x))
    jp = jgcn.init(jax.random.PRNGKey(1), d, c.d_hidden, c.n_classes)
    tp = tcommon.params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    got = tgcn.forward(tp, tb, use_spmm_kernel=True)
    assert tuple(got.shape) == (n, c.n_classes)
    assert_close(got, jgcn.forward(jp, jb), "gcn forward")
    labels = np.random.default_rng(5).integers(0, c.n_classes, n)
    lmask = np.random.default_rng(6).random(n) < 0.2
    assert_close(tgcn.loss_fn(tp, tb, _t(labels), _t(lmask)),
                 jgcn.loss_fn(jp, jb, jnp.asarray(labels), jnp.asarray(lmask)))


def test_gcn_init_shapes():
    p = tgcn.init(torch.Generator().manual_seed(0), 1433, 16, 7, device=CPU)
    assert [tuple(w.shape) for w in p["ws"]] == [(1433, 16), (16, 7)]


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: tsage.init(gen, 4, 4, 2), lambda: tgcn.init(gen, 4, 4, 2),
                 lambda: tcommon.params_from_numpy({"w": np.ones(2)}),
                 lambda: tcommon.batch_from_edges(3, np.zeros((1, 2)), np.zeros((3, 1)))):
        with pytest.raises(RuntimeError, match="no GPU"):
            call()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run: python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_forward_sampled_kernel_matches_plain(cuda):
    offsets, nbrs = tpipe.power_law_graph(5000, 40_000, seed=0)
    feats = torch.randn((5000, 602), generator=torch.Generator().manual_seed(0))
    port = tpipe.NeighborSampler(_t(offsets).to(cuda), _t(nbrs).to(cuda), feats.to(cuda))
    b = port.sample_batch(0, 0, 64, (15, 10))
    p = tsage.init(torch.Generator().manual_seed(1), 602, 128, 41, device=cuda)
    before = sr.LAUNCHES["fanout_aggregate"]
    got = tsage.forward_sampled(p, b["x_self"], b["neigh_feats"], b["neigh_masks"], True)
    torch.cuda.synchronize()
    assert sr.LAUNCHES["fanout_aggregate"] == before + 3
    want = tsage.forward_sampled(p, b["x_self"], b["neigh_feats"], b["neigh_masks"], False)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * float(want.abs().max()))
