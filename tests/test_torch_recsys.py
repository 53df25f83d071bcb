"""The port's recsys path (registry, embedding tables, DCN-v2, the recsys
batch) against the JAX reference.

Both packages get the same numpy inputs and the same parameters (the
reference's ``init`` draws, carried across with ``params_from_numpy``).
Exactness classes: configs, the recsys batch, one-hot lookups and the
C-tree bag bridge (gathers and integer work) are bit-identical; bag sums
and means, logits, scores and losses hold to rtol 1e-5, atol 1e-5 *
max|reference| (float32 sums in another order); top-k ids exactly, on
scores without ties.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import dcn_v2 as jdcn_cfg
from repro.configs import registry as jreg
from repro.core import flat_graph as jfg
from repro.data import pipeline as jpipe
from repro.models.recsys import dcn_v2 as jdcn
from repro.models.recsys import embedding as jemb
from repro_torch.configs import dcn_v2 as tdcn_cfg
from repro_torch.configs import registry as treg
from repro_torch.core import flat_graph as tfg
from repro_torch.data import pipeline as tpipe
from repro_torch.models import layers as tL
from repro_torch.models.recsys import dcn_v2 as tdcn
from repro_torch.models.recsys import embedding as temb

CPU = "cpu"


def _t(x):
    return torch.from_numpy(np.array(x))


def assert_close(got, want, what=""):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale, err_msg=what)


def test_configs_match_reference():
    assert treg.RECSYS_SHAPES == jreg.RECSYS_SHAPES
    for which in ("FULL", "REDUCED"):
        t, j = getattr(tdcn_cfg, which), getattr(jdcn_cfg, which)
        assert dataclass_items(t) == dataclass_items(j)
    spec, ref = treg.get("dcn-v2"), jreg.get("dcn-v2")
    assert (spec.arch_id, spec.family, spec.shapes) == (ref.arch_id, ref.family, ref.shapes)
    assert treg.ARCH_IDS == [a for a in jreg.ARCH_IDS if a in treg.ARCH_IDS]
    assert "dcn-v2" in treg.ARCH_IDS


def dataclass_items(c):
    return [(f, getattr(c, f)) for f in c.__dataclass_fields__]


@pytest.mark.parametrize("step,batch,vocab", [(0, 16, 1000), (3, 33, 100_000), (7, 5, 7)])
def test_recsys_batch_bit_identical(step, batch, vocab):
    got = tpipe.recsys_batch(1, step, batch, 4, 6, vocab)
    want = jpipe.recsys_batch(1, step, batch, 4, 6, vocab)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def tables(F=5, V=40, D=6, seed=0):
    jp = jemb.init_field_tables(jax.random.PRNGKey(seed), F, V, D)
    return jp, tL.params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)


def test_init_field_tables_shape_and_scale():
    p = temb.init_field_tables(torch.Generator().manual_seed(0), 4, 500, 16, device=CPU)
    assert tuple(p["tables"].shape) == (4, 500, 16) and p["tables"].dtype == torch.float32
    assert float(p["tables"].std()) == pytest.approx(16 ** -0.5, rel=0.1)


def test_lookup_onehot_bit_identical():
    jp, tp = tables()
    ids = np.random.default_rng(1).integers(0, 40, (9, 5))
    got = temb.lookup_onehot(tp, _t(ids))
    want = jemb.lookup_onehot(jp, jnp.asarray(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("op", ["sum", "mean"])
@pytest.mark.parametrize("short", [0, 3])
def test_lookup_bags_matches_reference(op, short):
    """Bags of 0-6 ids (an empty bag among them); with ``short`` the
    offsets cover fewer ids than there are, and the rest go to the last
    bag, as the reference's ``total_repeat_length`` puts them."""
    rng = np.random.default_rng(2)
    jp, tp = tables()
    lens = rng.integers(0, 7, 12)
    lens[4] = 0
    offsets = np.concatenate([[0], np.cumsum(lens)])
    L = int(offsets[-1]) + short
    flat = rng.integers(0, 40, L)
    field = rng.integers(0, 5, 12)
    got = temb.lookup_bags(tp, _t(flat), _t(offsets), _t(field), 12, op)
    want = jemb.lookup_bags(jp, jnp.asarray(flat), jnp.asarray(offsets), jnp.asarray(field), 12,
                            op)
    assert_close(got, want, f"lookup_bags {op}")


def test_bags_from_ctree_pool_bit_identical():
    """A user->item interaction log in the port's flat pool and the
    reference's, from the same keys (pad slots included)."""
    rng = np.random.default_rng(3)
    n_users = 50
    edges = np.unique(rng.integers(0, n_users, (400, 2)), axis=0)
    edges = edges[edges[:, 0] % 7 != 3]  # users with no interactions
    jg, tg = jfg.from_edges(n_users, edges), tfg.from_edges(n_users, edges, device=CPU)
    assert tg.edge_capacity > int(tg.m)
    want_items, want_offs = jemb.bags_from_ctree_pool(jg.keys, jg.m, n_users)
    got_items, got_offs = temb.bags_from_ctree_pool(tg.keys, tg.m, n_users)
    assert got_items.dtype == torch.int32 and got_offs.dtype == torch.int32
    np.testing.assert_array_equal(got_items.numpy(), np.asarray(want_items))
    np.testing.assert_array_equal(got_offs.numpy(), np.asarray(want_offs))
    # the bridge's bags are the log's per-user item lists
    offs = got_offs.numpy()
    for u in (0, 3, 10, 49):
        np.testing.assert_array_equal(got_items.numpy()[offs[u]:offs[u + 1]],
                                      edges[edges[:, 0] == u, 1])


def dcn_pair(n_candidates=512, seed=4):
    c = jdcn_cfg.REDUCED
    jp = jdcn.init(jax.random.PRNGKey(seed), n_dense=c.n_dense, n_sparse=c.n_sparse,
                   embed_dim=c.embed_dim, vocab_per_field=c.vocab_per_field, n_cross=c.n_cross,
                   mlp_dims=c.mlp_dims, n_candidates=n_candidates)
    # the cross biases start at zero: randomise them to test the add
    rng = np.random.default_rng(seed)
    for cp in jp["cross"]:
        cp["b"] = jnp.asarray(0.1 * rng.standard_normal(cp["b"].shape), jnp.float32)
    return c, jp, tL.params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)


def test_dcn_init_layout_matches_reference():
    c = tdcn_cfg.REDUCED
    tp = tdcn.init(torch.Generator().manual_seed(0), n_dense=c.n_dense, n_sparse=c.n_sparse,
                   embed_dim=c.embed_dim, vocab_per_field=c.vocab_per_field, n_cross=c.n_cross,
                   mlp_dims=c.mlp_dims, n_candidates=c.n_candidates, device=CPU)
    _, jp, _ = dcn_pair()
    tl, tdef = jax.tree.flatten(tp)
    jl, jdef = jax.tree.flatten(jp)
    assert tdef == jdef
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32


@pytest.mark.parametrize("batch", [1, 37])
def test_dcn_forward_serve_loss_match_reference(batch):
    c, jp, tp = dcn_pair()
    b = jpipe.recsys_batch(2, 0, batch, c.n_dense, c.n_sparse, c.vocab_per_field)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: _t(v) for k, v in b.items()}
    jc, jd = jdcn.trunk(jp, jb["dense"], jb["sparse_ids"])
    tc, td = tdcn.trunk(tp, tb["dense"], tb["sparse_ids"])
    assert_close(tc, jc, "cross")
    assert_close(td, jd, "deep")
    assert_close(tdcn.forward(tp, tb["dense"], tb["sparse_ids"]),
                 jdcn.forward(jp, jb["dense"], jb["sparse_ids"]), "forward")
    assert_close(tdcn.serve(tp, tb["dense"], tb["sparse_ids"]),
                 jdcn.serve(jp, jb["dense"], jb["sparse_ids"]), "serve")
    assert_close(tdcn.loss_fn(tp, tb["dense"], tb["sparse_ids"], tb["labels"]),
                 jdcn.loss_fn(jp, jb["dense"], jb["sparse_ids"], jb["labels"]), "loss")


def test_dcn_loss_is_stable_at_large_logits():
    """The stable BCE form: finite at logits of +-1e4, as the reference."""
    _, jp, tp = dcn_pair()
    tp["logit"]["bs"][0] = torch.full((1,), 1e4)
    jp["logit"]["bs"][0] = jnp.full((1,), 1e4)
    b = jpipe.recsys_batch(3, 0, 8, 4, 6, 1000)
    got = tdcn.loss_fn(tp, _t(b["dense"]), _t(b["sparse_ids"]), _t(b["labels"]))
    want = jdcn.loss_fn(jp, jnp.asarray(b["dense"]), jnp.asarray(b["sparse_ids"]),
                        jnp.asarray(b["labels"]))
    assert np.isfinite(float(got))
    assert_close(got, want, "loss at large logits")


@pytest.mark.parametrize("top_k", [1, 10, 100])
def test_dcn_retrieval_matches_reference(top_k):
    c, jp, tp = dcn_pair()
    b = jpipe.recsys_batch(5, 0, 1, c.n_dense, c.n_sparse, c.vocab_per_field)
    ts, ti = tdcn.retrieval(tp, _t(b["dense"]), _t(b["sparse_ids"]), top_k)
    js, ji = jdcn.retrieval(jp, jnp.asarray(b["dense"]), jnp.asarray(b["sparse_ids"]), top_k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert_close(ts, js, "top scores")


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: tdcn.init(gen, 2, 2, 2, 10, 1, (4,)),
                 lambda: temb.init_field_tables(gen, 2, 3, 4)):
        with pytest.raises(RuntimeError, match="no GPU"):
            call()
