"""The port's train step (loss -> grads -> clip -> AdamW) against the
reference's jitted step, family by family.

Both packages start from the same parameters (the reference's ``init``
draws, carried across with ``params_from_numpy``) and take the same
numpy batches.  After each of three steps every leaf of the state —
parameters, both moments, the step counter — and the metrics are held
to the reference's.  The leaf paths are compared too: they are the
strings both packages' checkpoints write.

Tolerances (DESIGN.md §5, the float32 class): loss rtol 1e-5; grad norm,
lr, parameters and moments rtol 1e-4 with atol 1e-4 * max|reference
leaf| (float32 sums in another order, through one to three AdamW steps);
``step`` exactly.  ``n_micro=2`` runs where axis 0 is a batch axis (LM
tokens, sampled minibatches, CTR rows); the full-graph GNN batches are
one graph, which the reference's reshape would cut into meaningless
halves, so they run with ``n_micro=1`` only.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.checkpoint import checkpoint as jckpt
from repro.configs import dcn_v2 as jdcn_cfg
from repro.configs import smollm_360m as jsmol
from repro.data import pipeline as jpipe
from repro.models import transformer as jT
from repro.models.gnn import common as jcommon
from repro.models.gnn import gcn as jgcn
from repro.models.gnn import graphsage as jsage
from repro.models.recsys import dcn_v2 as jdcn
from repro.optim import adamw as jadamw
from repro.train import train_step as jTS
from repro_torch import _tree
from repro_torch.configs import smollm_360m as tsmol
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from repro_torch.models.gnn import common as tcommon
from repro_torch.optim import adamw as tadamw
from repro_torch.train import train_step as tTS

CPU = "cpu"
LR = dict(warmup=1, stable=10, decay=5, peak_lr=3e-3)


def _t(x):
    return torch.from_numpy(np.array(x))


def carry(jp):
    return tL.params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)


def close(got, want, what, rtol=1e-4):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, err_msg=what)


def assert_state_close(ts, js, what):
    tflat = _tree.flatten_with_paths(ts)
    jpaths, jleaves, _ = jckpt._flatten_with_paths(js)
    assert [p for p, _ in tflat] == jpaths, what
    for (path, t), j in zip(tflat, jleaves):
        close(t, j, f"{what} {path}")


# -- the five families: (reference loss, port loss, params, batch maker) -------


def lm_case(remat="none", batch=4, seq=16):
    jcfg = dataclasses.replace(jsmol.REDUCED, remat=remat)
    tcfg = dataclasses.replace(tsmol.REDUCED, remat=remat)
    jp = jT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)

    def batches(step):
        return jpipe.token_batch(0, step, batch, seq, jcfg.vocab)

    return jTS.lm_loss(jcfg), tTS.lm_loss(tcfg), jp, batches


def graph_pair(seed, n=120, d=10, n_classes=5):
    rng = np.random.default_rng(seed)
    offsets, nbrs = jpipe.power_law_graph(n, 500, seed=seed)
    edges = np.stack([np.repeat(np.arange(n), np.diff(offsets)), nbrs], 1)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cap = edges.shape[0] + 9
    jb = jcommon.batch_from_edges(n, edges, x, edge_capacity=cap)
    tb = tcommon.batch_from_edges(n, edges, x, edge_capacity=cap, device=CPU)

    def batches(step):
        r = np.random.default_rng(100 + step)
        return {"labels": r.integers(0, n_classes, n), "label_mask": r.random(n) < 0.4}

    return jb, tb, batches


def gcn_case():
    jb, tb, labels = graph_pair(1)
    jp = jgcn.init(jax.random.PRNGKey(1), 10, 16, 5)
    return _graph_loss(jTS.gcn_loss(None), jb), _graph_loss(tTS.gcn_loss(None), tb), jp, labels


def sage_full_case():
    jb, tb, labels = graph_pair(2)
    jp = jsage.init(jax.random.PRNGKey(2), 10, 16, 5)
    return (_graph_loss(jTS.sage_full_loss(), jb), _graph_loss(tTS.sage_full_loss(), tb), jp,
            labels)


def _graph_loss(loss, graph):
    """The family's loss with its graph bound."""
    def f(params, batch):
        return loss(params, {"graph": graph, **batch})
    return f


def sage_sampled_case(B=8):
    offsets, nbrs = jpipe.power_law_graph(300, 1500, seed=3)
    feats = np.random.default_rng(3).standard_normal((300, 12)).astype(np.float32)
    sampler = jpipe.NeighborSampler(offsets, nbrs, feats)
    jp = jsage.init(jax.random.PRNGKey(3), 12, 16, 5)

    def batches(step):
        b = sampler.sample_batch(0, step, B, (4, 3))
        return {"x_self": b["x_self"], "neigh_feats": b["neigh_feats"],
                "neigh_masks": b["neigh_masks"], "labels": b["seeds"] % 5}

    return jTS.sage_sampled_loss(), tTS.sage_sampled_loss(), jp, batches


def dcn_case(batch=16):
    c = jdcn_cfg.REDUCED
    jp = jdcn.init(jax.random.PRNGKey(4), n_dense=c.n_dense, n_sparse=c.n_sparse,
                   embed_dim=c.embed_dim, vocab_per_field=c.vocab_per_field,
                   n_cross=c.n_cross, mlp_dims=c.mlp_dims)

    def batches(step):
        return jpipe.recsys_batch(0, step, batch, c.n_dense, c.n_sparse, c.vocab_per_field)

    return jTS.dcn_loss(), tTS.dcn_loss(), jp, batches


CASES = {"lm": lm_case, "gcn": gcn_case, "sage_full": sage_full_case,
         "sage_sampled": sage_sampled_case, "dcn": dcn_case}


def to_jax(batch):
    return jax.tree.map(jnp.asarray, batch)


def to_torch(batch):
    return _tree.tree_map(_t, batch)


def run_both(case, n_steps=3, n_micro=1, clip_norm=1.0):
    jloss, tloss, jp, batches = case
    jstep = jax.jit(jTS.make_train_step(jloss, jadamw.wsd_schedule(**LR), clip_norm=clip_norm,
                                        n_micro=n_micro))
    tstep = tTS.make_train_step(tloss, tadamw.wsd_schedule(**LR), clip_norm=clip_norm,
                                n_micro=n_micro)
    js, ts = jTS.init_state(jp), tTS.init_state(carry(jp))
    for step in range(n_steps):
        b = batches(step)
        js, jm = jstep(js, to_jax(b))
        ts, tm = tstep(ts, to_torch(b))
        close(tm["loss"], jm["loss"], f"loss at step {step}", rtol=1e-5)
        close(tm["grad_norm"], jm["grad_norm"], f"grad_norm at step {step}")
        close(tm["lr"], jm["lr"], f"lr at step {step}")
        assert_state_close(ts, js, f"step {step}:")
    return ts


@pytest.mark.parametrize("family", list(CASES))
def test_train_step_matches_reference(family):
    ts = run_both(CASES[family]())
    assert int(ts.opt.step) == 3


@pytest.mark.parametrize("family", ["lm", "sage_sampled", "dcn"])
def test_train_step_n_micro_2_matches_reference_scan(family):
    run_both(CASES[family](), n_micro=2)


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_lm_remat_train_step_matches_reference(remat):
    run_both(lm_case(remat))


def test_clip_inactive_matches_reference():
    """A clip norm above the gradient norm leaves the gradients as they are."""
    run_both(dcn_case(), n_steps=2, clip_norm=1e6)


def lm_grads(remat):
    _, tloss, jp, batches = lm_case(remat)
    b = to_torch(batches(0))
    return tTS._value_and_grad(tloss, carry(jp), b)


def test_remat_settings_give_equal_gradients():
    """none / full / dots recompute the same float32 operations: the
    gradients agree to rtol 1e-6, atol 1e-6 * max|g|."""
    loss0, g0 = lm_grads("none")
    for remat in ("full", "dots"):
        loss, g = lm_grads(remat)
        assert float(loss) == float(loss0)
        for (path, a), b in zip(_tree.flatten_with_paths(g), _tree.leaves(g0)):
            scale = float(b.abs().max())
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6 * scale, msg=f"{remat} {path}")


class CountOps(TorchDispatchMode):
    """Counts the softmaxes and the one-batch products (the unbatched
    dots, as ``einsum`` lays them out) that run inside the mode."""

    def __init__(self):
        super().__init__()
        self.softmax = self.unbatched_dots = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._softmax.default:
            self.softmax += 1
        if func is torch.ops.aten.bmm.default and args[0].shape[0] == 1:
            self.unbatched_dots += 1
        return func(*args, **(kwargs or {}))


def test_dots_policy_recomputes_all_but_the_unbatched_products():
    """The backward pass of "dots" recomputes each layer's softmax but
    none of its projection or MLP products (as many of those as with no
    checkpointing); "full" recomputes both."""
    _, _, jp, batches = lm_case()
    b = to_torch(batches(0))
    counts = {}
    for remat in ("none", "dots", "full"):
        params = _tree.tree_map(lambda p: p.requires_grad_(True), carry(jp))
        loss = tT.loss_fn(params, dataclasses.replace(tsmol.REDUCED, remat=remat), b["tokens"],
                          b["labels"])
        with CountOps() as c:
            loss.backward()
        counts[remat] = (c.softmax, c.unbatched_dots)
    n = tsmol.REDUCED.n_layers
    assert counts["none"][0] == 0 and counts["dots"][0] == counts["full"][0] == n
    assert counts["dots"][1] == counts["none"][1] < counts["full"][1]


def test_value_and_grad_gives_zeros_for_unused_leaves():
    params = {"used": torch.ones(3), "unused": torch.ones(2, dtype=torch.float32)}
    loss, g = tTS._value_and_grad(lambda p, b: (p["used"] * b).sum(), params, torch.arange(3.0))
    assert float(loss) == 3.0
    assert torch.equal(g["used"], torch.arange(3.0)) and torch.equal(g["unused"], torch.zeros(2))
    assert not params["used"].requires_grad


def test_n_micro_needs_a_divisible_batch():
    step = tTS.make_train_step(lambda p, b: (p["w"] * b["x"]).sum(),
                               tadamw.wsd_schedule(1, 1, 1, 1.0), n_micro=2)
    with pytest.raises(ValueError, match="split"):
        step(tTS.init_state({"w": torch.ones(1)}), {"x": torch.ones(3)})


def test_schnet_and_graphcast_name_the_roadmap_item():
    with pytest.raises(NotImplementedError, match="item 14"):
        tTS.schnet_loss(4)
    with pytest.raises(NotImplementedError, match="item 14"):
        tTS.graphcast_loss()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run: python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["lm", "dcn"])
def test_cuda_train_step_matches_cpu(family, cuda):
    """Three steps on the card and on the CPU from the same parameters and
    batches: metrics and every leaf of the state to the tolerances above
    (TF32 off: full float32 products on the card)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    _, tloss, jp, batches = CASES[family]()
    step = tTS.make_train_step(tloss, tadamw.wsd_schedule(**LR))
    cpu = tTS.init_state(carry(jp))
    gpu = _tree.tree_map(lambda x: x.to(cuda), cpu)
    for s in range(3):
        b = to_torch(batches(s))
        cpu, cm = step(cpu, b)
        gpu, gm = step(gpu, _tree.tree_map(lambda x: x.to(cuda), b))
        assert gm["loss"].device.type == "cuda"
        close(gm["loss"], cm["loss"].numpy(), f"loss at step {s}", rtol=1e-5)
        close(gm["grad_norm"], cm["grad_norm"].numpy(), f"grad_norm at step {s}")
        for (path, g), c in zip(_tree.flatten_with_paths(gpu), _tree.leaves(cpu)):
            close(g, c.numpy(), f"step {s}: {path}")
