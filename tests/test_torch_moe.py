"""The port's MoE block (``models/moe.py``) against the reference's.

Both packages get the same numpy inputs and the reference's parameters
(``moe_init`` with ``jax.random``, carried across with
``params_from_numpy``).  The routing — each token's experts, the stable
sort, which pairs keep a slot and which slot — must be exactly equal;
the reference's routing is computed by ``ref_routing``, the lines of
``repro/models/moe.py:63-93`` on the reference's own arrays.  A
near-tie at the k-th expert that flips a choice is reported by the
failing assertion (the margin between the k-th and (k+1)-th
probabilities), not avoided by choosing other data.

Tolerance, float32: rtol 1e-5, atol 1e-5 * max|reference| (sums in
another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jM
from repro.models import transformer as jT
from repro_torch.models import layers as tL
from repro_torch.models import moe as tM
from repro_torch.models import transformer as tT

CPU = "cpu"


def assert_close(got, want, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale, err_msg=what)


def configs(capacity_factor=16.0, dispatch_shards=0, n_shared=0, shard_dispatch=False):
    """The reference test's MoE layer (tests/test_moe.py), as both packages'
    configs."""
    fields = dict(n_experts=8, top_k=2, capacity_factor=capacity_factor,
                  dispatch_shards=dispatch_shards, n_shared=n_shared,
                  shared_d_ff=16 if n_shared else 0, shard_dispatch=shard_dispatch)
    common = dict(name="m", n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=16, vocab=64)
    return (jT.LMConfig(**common, moe=jT.MoEFields(**fields)),
            tT.LMConfig(**common, moe=tT.MoEFields(**fields)))


def setup(shape=(8, 4, 32), seed=0, **kw):
    """Both configs, the reference's float32 parameters and the port's
    copy, and x drawn with numpy."""
    jcfg, tcfg = configs(**kw)
    jp = jM.moe_init(jax.random.PRNGKey(seed), jcfg, dtype=jnp.float32)
    tp = tL.params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jcfg, tcfg, jp, tp, x


def ref_routing(params, cfg, x):
    """The reference's routing (repro/models/moe.py:63-93), on its arrays."""
    m = cfg.moe
    B, S, D = x.shape
    T = B * S
    xt = jnp.asarray(x).reshape(T, D)
    C = jM._capacity(T, m)
    logits = jnp.einsum("td,de->te", xt.astype(jnp.float32), params["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, m.top_k)
    top_p = top_p / jnp.maximum(top_p.sum(-1, keepdims=True), 1e-9)
    flat_e = top_e.reshape(-1)
    flat_t = jnp.repeat(jnp.arange(T), m.top_k)
    if m.dispatch_shards > 1:
        ns = m.dispatch_shards
        C_local = max(8, -(-C // ns))
        C = C_local * ns
        shard_of = flat_t // max(T // ns, 1)
        group = flat_e * ns + shard_of
        order = jnp.argsort(group, stable=True)
        g_sorted = group[order]
        e_sorted = flat_e[order]
        first_of_g = jnp.searchsorted(g_sorted, jnp.arange(m.n_experts * ns))
        rank = jnp.arange(T * m.top_k) - first_of_g[g_sorted]
        keep = rank < C_local
        slot = e_sorted * C + (g_sorted % ns) * C_local + rank
    else:
        order = jnp.argsort(flat_e, stable=True)
        e_sorted = flat_e[order]
        first_of_e = jnp.searchsorted(e_sorted, jnp.arange(m.n_experts))
        rank = jnp.arange(T * m.top_k) - first_of_e[e_sorted]
        keep = rank < C
        slot = e_sorted * C + rank
    out = dict(top_p=top_p, top_e=top_e, order=order, keep=keep, slot=slot,
               src_tok=flat_t[order], probs=probs)
    return {k: np.asarray(v) for k, v in out.items()}, C


def assert_routing_equal(got: tM.Routing, want, C, what=""):
    """Exactly equal routing; a differing expert choice is reported with
    its probability margin at the k-th place."""
    k = want["top_e"].shape[1]
    srt = -np.sort(-want["probs"], axis=-1)
    margin = srt[:, k - 1] - srt[:, k]
    bad = np.nonzero((got.top_e.numpy() != want["top_e"]).any(-1))[0]
    assert bad.size == 0, (f"{what}: tokens {bad.tolist()} route differently; their k-th "
                           f"margins {margin[bad].tolist()} (smallest in the batch "
                           f"{float(margin.min())})")
    assert got.capacity == C
    for name in ("order", "keep", "slot", "src_tok"):
        g = getattr(got, name).numpy()
        if name == "slot":  # a dropped pair's slot is never used
            g, w = g[want["keep"]], want["slot"][want["keep"]]
        else:
            w = want[name]
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
    assert_close(got.top_p, want["top_p"], f"{what} top_p")


CASES = [(dispatch, cap, shared) for dispatch in (0, 4) for cap in (1.25, 16.0)
         for shared in (0, 1)]
# At capacity 1.25 the batch is 256 tokens: at 32 the round-up of C to
# a multiple of 8 leaves every expert room and nothing drops.
SHAPE = {1.25: (16, 16, 32), 16.0: (8, 4, 32)}


@pytest.mark.parametrize("dispatch,cap,shared", CASES)
def test_routing_matches_reference(dispatch, cap, shared):
    """Both dispatch branches, at a capacity that drops pairs and at one
    that keeps them all."""
    jcfg, tcfg, jp, tp, x = setup(SHAPE[cap], capacity_factor=cap, dispatch_shards=dispatch,
                                  n_shared=shared)
    want, C = ref_routing(jp, jcfg, x)
    got = tM.route(tp, tcfg, torch.from_numpy(x).reshape(-1, x.shape[-1]))
    assert_routing_equal(got, want, C, f"dispatch {dispatch} capacity {cap}")
    assert bool(got.keep.all()) == (cap == 16.0)


@pytest.mark.parametrize("dispatch,cap,shared", CASES)
def test_moe_apply_matches_reference(dispatch, cap, shared):
    jcfg, tcfg, jp, tp, x = setup(SHAPE[cap], capacity_factor=cap, dispatch_shards=dispatch,
                                  n_shared=shared)
    assert_close(tM.moe_apply(tp, tcfg, torch.from_numpy(x)),
                 jM.moe_apply(jp, jcfg, jnp.asarray(x)), f"dispatch {dispatch} capacity {cap}")


def test_hierarchical_group_past_the_last_matches_reference():
    """T = 10 tokens over 4 dispatch shards: tokens 8 and 9 fall in a shard
    past the last, whose group the reference's clamped gather reads as the
    last group's start; the port does the same."""
    jcfg, tcfg, jp, tp, x = setup(shape=(5, 2, 32), seed=2, capacity_factor=1.25,
                                  dispatch_shards=4)
    want, C = ref_routing(jp, jcfg, x)
    got = tM.route(tp, tcfg, torch.from_numpy(x).reshape(10, 32))
    assert_routing_equal(got, want, C, "T = 10, 4 shards")
    assert_close(tM.moe_apply(tp, tcfg, torch.from_numpy(x)),
                 jM.moe_apply(jp, jcfg, jnp.asarray(x)), "T = 10, 4 shards")


@pytest.mark.parametrize("n_tokens", [1, 8, 10, 32, 2048])
def test_capacity_matches_reference(n_tokens):
    for cap in (0.25, 1.25, 16.0):
        jcfg, tcfg = configs(capacity_factor=cap)
        assert tM._capacity(n_tokens, tcfg.moe) == jM._capacity(n_tokens, jcfg.moe)


def test_load_balance_loss_matches_reference():
    logits = np.random.default_rng(3).standard_normal((64, 8)).astype(np.float32)
    _, top_e = jax.lax.top_k(jax.nn.softmax(jnp.asarray(logits)), 2)
    want = jM.load_balance_loss(jnp.asarray(logits), top_e, 8)
    got = tM.load_balance_loss(torch.from_numpy(logits), torch.from_numpy(np.array(top_e)), 8)
    assert_close(got, want, "load_balance_loss")
    assert float(got) >= 1.0 - 1e-3  # >= 1 at or near balance, > 1 when skewed


# -- the reference's tests/test_moe.py, on the port ----------------------------


def test_hierarchical_dispatch_matches_baseline():
    _, tcfg0, _, tp, x = setup()
    _, tcfg1 = configs(dispatch_shards=4)
    xt = torch.from_numpy(x)
    torch.testing.assert_close(tM.moe_apply(tp, tcfg1, xt), tM.moe_apply(tp, tcfg0, xt),
                               rtol=0, atol=1e-6)


def test_moe_conserves_tokens_under_huge_capacity():
    """With capacity far above the need, every token is processed exactly
    top_k ways: the output equals the dense per-token top-k sum."""
    _, tcfg, _, tp, x = setup(capacity_factor=32.0)
    xt = torch.from_numpy(x)
    out = tM.moe_apply(tp, tcfg, xt)
    assert out.shape == xt.shape and bool(out.isfinite().all())
    r = tM.route(tp, tcfg, xt.reshape(-1, 32))
    assert bool(r.keep.all())
    dense = torch.zeros(32, 32)
    for t in range(32):
        for j in range(tcfg.moe.top_k):
            e = int(r.top_e[t, j])
            w = {k: tp[k][e] for k in ("w_gate", "w_up", "w_down")}
            dense[t] += r.top_p[t, j] * tL.swiglu(w, xt.reshape(-1, 32)[t])
    torch.testing.assert_close(out.reshape(-1, 32), dense, rtol=1e-5, atol=1e-6)


def test_capacity_drops_are_bounded():
    """A tiny capacity drops pairs but never corrupts the others: a token
    whose pairs all dropped gets 0, the rest stay finite."""
    _, tcfg, _, tp, x = setup(capacity_factor=0.25)
    xt = torch.from_numpy(x)
    out = tM.moe_apply(tp, tcfg, xt)
    assert bool(out.isfinite().all())
    r = tM.route(tp, tcfg, xt.reshape(-1, 32))
    kept_tok = torch.zeros(32, dtype=torch.bool)
    kept_tok[r.src_tok[r.keep]] = True
    assert 0 < int(r.keep.sum()) <= tcfg.moe.n_experts * r.capacity
    assert bool((out.reshape(-1, 32)[~kept_tok] == 0).all())


def test_shard_dispatch_is_inert():
    """shard_dispatch pins GSPMD shardings in the reference; on one card
    the port's output is the same bits with it on or off."""
    _, tcfg, _, tp, x = setup()
    _, tcfg_sd = configs(shard_dispatch=True)
    xt = torch.from_numpy(x)
    assert torch.equal(tM.moe_apply(tp, tcfg_sd, xt), tM.moe_apply(tp, tcfg, xt))


def test_shardmap_raises_naming_item_16():
    with pytest.raises(NotImplementedError, match="item 16"):
        dataclasses.replace(configs()[1], moe_impl="shardmap")


def test_moe_init_layout_matches_reference():
    jcfg, tcfg = configs(n_shared=2)
    jp = jM.moe_init(jax.random.PRNGKey(0), jcfg)
    tp = tM.moe_init(torch.Generator().manual_seed(0), tcfg, device=CPU)
    assert jax.tree.structure(tp) == jax.tree.structure(jp)
    for t, j in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        assert tuple(t.shape) == j.shape and str(t.dtype).split(".")[1] == str(j.dtype)
