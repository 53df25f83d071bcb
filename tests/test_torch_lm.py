"""The port's dense LM serving path (layers, transformer, serve, launcher)
against the JAX reference.

Both packages get the same numpy inputs and the same weights: the
reference's ``init_params`` draws them with ``jax.random`` and
``layers.params_from_numpy`` carries them across (bf16 leaves bit for
bit), since torch cannot reproduce those draws.  The qwen configs' QKV
biases start at zero, so the tests set them to random values to test the
bias add.  On the CPU the port's flash-decode wrapper runs its plain
version; the reference's ``use_flash_kernel=True`` path runs its Pallas
kernel in interpret mode.

Tolerance, everywhere in float32: rtol 1e-5, atol 1e-5 * max|reference|
(float32 sums and products in another order).  Greedy tokens are
compared exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import deepseek_moe_16b as jdeep
from repro.configs import qwen2_5_3b as jqwen
from repro.configs import qwen3_moe_30b_a3b as jqmoe
from repro.configs import registry as jreg
from repro.configs import smollm_360m as jsmol
from repro.configs import starcoder2_7b as jstar
from repro.models import layers as jL
from repro.models import transformer as jT
from repro.models.gnn import graphsage as jsage
from repro.serve import decode as jserve
from repro_torch.configs import deepseek_moe_16b as tdeep
from repro_torch.configs import qwen2_5_3b as tqwen
from repro_torch.configs import qwen3_moe_30b_a3b as tqmoe
from repro_torch.configs import registry as treg
from repro_torch.configs import smollm_360m as tsmol
from repro_torch.configs import starcoder2_7b as tstar
from repro_torch.kernels import _build
from repro_torch.launch import serve as tlaunch
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from repro_torch.models.gnn import common as tcommon
from repro_torch.serve import decode as tserve

CPU = "cpu"
DENSE_ARCHS = ["smollm-360m", "qwen2.5-3b", "starcoder2-7b"]
LM_ARCHS = DENSE_ARCHS + ["qwen3-moe-30b-a3b", "deepseek-moe-16b"]


def assert_close(got, want, what=""):
    want = np.asarray(want, np.float32)
    got = got.detach().float().cpu().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale, err_msg=what)


def _t(x):
    return torch.from_numpy(np.array(x))


def lm_params(arch, seed=0, dtype=jnp.float32):
    """The reference's REDUCED params (QKV biases randomised) and the
    port's copy of them."""
    cfg = jreg.get(arch).reduced
    jp = jT.init_params(jax.random.PRNGKey(seed), cfg, dtype=dtype)
    if cfg.qkv_bias:
        rng = np.random.default_rng(seed + 1)
        for b in ("bq", "bk", "bv"):
            shape = jp["layers"]["attn"][b].shape
            jp["layers"]["attn"][b] = jnp.asarray(0.1 * rng.standard_normal(shape), dtype)
    return cfg, treg.get(arch).reduced, jp, tL.params_from_numpy(jax.tree.map(np.asarray, jp),
                                                                  device=CPU)


@pytest.fixture
def no_kernel(monkeypatch):
    """Any attempt to reach a CUDA kernel fails the test."""

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA kernel")

    monkeypatch.setattr(_build, "launch", refuse)


# ---------------------------------------------------------------------------
# configs and parameters
# ---------------------------------------------------------------------------

DROPPED = {"unroll_layers"}


def config_items(c):
    """A config's fields in order, the MoE fields as their own items."""
    return [(f, config_items(getattr(c, f)) if f == "moe" and c.moe is not None
             else getattr(c, f)) for f in c.__dataclass_fields__ if f not in DROPPED]


def test_configs_match_reference():
    assert treg.LM_SHAPES == jreg.LM_SHAPES
    for tm, jm in ((tsmol, jsmol), (tqwen, jqwen), (tstar, jstar), (tqmoe, jqmoe),
                   (tdeep, jdeep)):
        for which in ("FULL", "REDUCED"):
            t, j = getattr(tm, which), getattr(jm, which)
            assert config_items(t) == config_items(j)
            assert all(getattr(j, f) == j.__dataclass_fields__[f].default for f in DROPPED)
            assert t.head_dim == j.head_dim and t.attn_config.__dict__ == j.attn_config.__dict__
            assert t.param_count() == j.param_count()
            assert t.active_param_count() == j.active_param_count()
            assert (t.active_param_count() == t.param_count()) == (t.moe is None)
    for arch in LM_ARCHS:
        spec, ref = treg.get(arch), jreg.get(arch)
        assert (spec.arch_id, spec.family, spec.shapes) == (ref.arch_id, ref.family, ref.shapes)


def _stacked_init_before(gen, cfg):
    """The dense init as it was: every layer drawn into its own tree, the
    trees then stacked with ``torch.stack`` (two copies of the stack)."""
    def stack(trees):
        if isinstance(trees[0], dict):
            return {k: stack([t[k] for t in trees]) for k in trees[0]}
        return torch.stack(trees)

    dev = torch.device(CPU)
    return {
        "embed": tL.embedding_init(gen, cfg.vocab, cfg.d_model, torch.bfloat16, dev),
        "layers": stack([tT._layer_init(gen, cfg, torch.bfloat16, dev)
                         for _ in range(cfg.n_layers)]),
        "ln_f": tL.rmsnorm_init(cfg.d_model, device=dev) if cfg.norm == "rmsnorm"
        else tL.layernorm_init(cfg.d_model, device=dev),
    }


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_init_params_draws_the_values_it_drew_before(arch):
    """Filling the stacked leaves layer by layer draws from the generator
    in the order the per-layer trees did: the same values, bit for bit."""
    cfg = dataclasses.replace(treg.get(arch).reduced, n_layers=3)
    got = tT.init_params(torch.Generator().manual_seed(5), cfg, device=CPU)
    want = _stacked_init_before(torch.Generator().manual_seed(5), cfg)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_init_params_layout_matches_reference(arch):
    """Same tree, shapes and dtypes as the reference's (bf16 default), every
    layer leaf with a leading n_layers axis."""
    cfg = treg.get(arch).reduced
    tp = tT.init_params(torch.Generator().manual_seed(0), cfg, device=CPU)
    jp = jT.init_params(jax.random.PRNGKey(0), jreg.get(arch).reduced)
    tl, tdef = jax.tree.flatten(tp)
    jl, jdef = jax.tree.flatten(jp)
    assert tdef == jdef
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == j.shape and str(t.dtype).split(".")[1] == str(j.dtype)
    assert tp["layers"]["attn"]["wq"].shape[0] == cfg.n_layers
    assert float(tp["embed"]["table"].float().std()) == pytest.approx(0.02, rel=0.2)


def test_params_from_numpy_carries_bf16_bit_for_bit():
    jp = jT.init_params(jax.random.PRNGKey(3), jsmol.REDUCED, dtype=jnp.bfloat16)
    npp = jax.tree.map(np.asarray, jp)
    tp = tL.params_from_numpy(npp, device=CPU)
    for t, a in zip(jax.tree.leaves(tp), jax.tree.leaves(npp)):
        if a.dtype.name == "bfloat16":
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(t.view(torch.int16).numpy(), a.view(np.int16))
        else:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), a)


def test_params_from_numpy_gnn_carry_unchanged():
    """The GNN modules import the same function (``gnn.common``), and a
    float32 GNN tree still arrives as it did: same structure, float32,
    equal values."""
    assert tcommon.params_from_numpy is tL.params_from_numpy
    jp = jsage.init(jax.random.PRNGKey(0), 12, 8, 5)
    npp = jax.tree.map(np.asarray, jp)
    tp = tcommon.params_from_numpy(npp, device=CPU)
    assert jax.tree.structure(tp) == jax.tree.structure(npp)
    for t, a in zip(jax.tree.leaves(tp), jax.tree.leaves(npp)):
        assert t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), a)
    tree = {"ws": (np.zeros(3, np.float32), [np.ones((2, 2), np.int32)]), "bs": None}
    got = tcommon.params_from_numpy(tree, device=CPU)
    assert isinstance(got["ws"], tuple) and got["bs"] is None
    assert got["ws"][1][0].dtype == torch.int32


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 2 + 0.5
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    assert_close(tL.rmsnorm({"scale": _t(scale)}, _t(x)),
                 jL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)), "rmsnorm")
    assert_close(tL.layernorm({"scale": _t(scale), "bias": _t(bias)}, _t(x)),
                 jL.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                              jnp.asarray(x)), "layernorm")
    init = tL.rmsnorm_init(7, device=CPU)
    assert init["scale"].dtype == torch.float32 and bool((init["scale"] == 1).all())
    ln = tL.layernorm_init(7, device=CPU)
    assert bool((ln["bias"] == 0).all())


@pytest.mark.parametrize("pos_shape", ["shared", "per_row"])
def test_rope_matches_reference(pos_shape):
    """Halves, not interleaved pairs; positions (1, S) as in prefill or
    each row's own (B, 1) as in decode."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    if pos_shape == "shared":
        pos = np.arange(6)[None, :]
    else:
        x = x[:, :1]
        pos = np.array([[5], [1000]], np.int32)
    assert_close(tL.apply_rope(_t(x), _t(pos), 10000.0),
                 jL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0), "rope")
    assert_close(tL.rope_freqs(16), jL.rope_freqs(16), "freqs")


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_gated_mlps_match_reference(kind):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 32)).astype(np.float32)
    init = jL.swiglu_init if kind == "swiglu" else jL.gelu_mlp_init
    jp = init(jax.random.PRNGKey(0), 32, 80, jnp.float32)
    tp = tL.params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    tf, jf = (tL.swiglu, jL.swiglu) if kind == "swiglu" else (tL.gelu_mlp, jL.gelu_mlp)
    assert_close(tf(tp, _t(x)), jf(jp, jnp.asarray(x)), kind)


@pytest.mark.parametrize("bias,final_act", [(True, False), (False, True)])
def test_mlp_matches_reference(bias, final_act):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 10)).astype(np.float32)
    jp = jL.mlp_init(jax.random.PRNGKey(1), 10, (16, 8, 3), bias=bias)
    if bias:
        jp["bs"] = [jnp.asarray(rng.standard_normal(b.shape), jnp.float32) for b in jp["bs"]]
    tp = tL.params_from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    assert_close(tL.mlp(tp, _t(x), final_act=final_act),
                 jL.mlp(jp, jnp.asarray(x), final_act=final_act), "mlp")
    got = tL.mlp_init(torch.Generator().manual_seed(0), 10, (16, 3), bias=bias, device=CPU)
    assert [tuple(w.shape) for w in got["ws"]] == [(10, 16), (16, 3)]
    assert (got["bs"] is None) == (not bias)


def test_embed_unembed_match_reference():
    rng = np.random.default_rng(4)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    tok = rng.integers(0, 50, (2, 7))
    x = rng.standard_normal((2, 7, 16)).astype(np.float32)
    np.testing.assert_array_equal(tL.embed({"table": _t(table)}, _t(tok)).numpy(),
                                  np.asarray(jL.embed({"table": jnp.asarray(table)},
                                                      jnp.asarray(tok))))
    assert_close(tL.unembed({"table": _t(table)}, _t(x)),
                 jL.unembed({"table": jnp.asarray(table)}, jnp.asarray(x)), "unembed")
    bf = tL.unembed({"table": _t(table).bfloat16()}, _t(x).bfloat16())
    assert bf.dtype == torch.float32
    init = tL.embedding_init(torch.Generator().manual_seed(0), 50, 16, device=CPU)
    assert init["table"].dtype == torch.bfloat16 and tuple(init["table"].shape) == (50, 16)


@pytest.mark.parametrize("S,impl", [(16, "chunked"), (3072, "chunked"), (3072, "tri")])
def test_attention_matches_reference(S, impl):
    """S = 16 takes the direct softmax; S = 3072 the blockwise online
    softmax, all kv-blocks masked (chunked) or the triangular schedule."""
    cfg, _, jp, tp = lm_params("qwen2.5-3b", seed=5)
    jacfg = jreg.get("qwen2.5-3b").reduced.attn_config
    jacfg = type(jacfg)(**{**jacfg.__dict__, "attn_impl": impl})
    tacfg = tL.AttnConfig(**jacfg.__dict__)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["attn"])
    tl = {k: v[0] for k, v in tp["layers"]["attn"].items()}
    x = np.random.default_rng(S).standard_normal((1, S, cfg.d_model)).astype(np.float32)
    assert_close(tL.attention(tl, tacfg, _t(x)), jL.attention(jl, jacfg, jnp.asarray(x)),
                 f"attention S={S} {impl}")


def _blockwise_qkv(S=4096, H=5, dh=12, seed=11):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((1, S, H, dh)).astype(np.float32) for _ in range(3)]


def test_blockwise_attention_saves_only_the_carries():
    """At REDUCED smollm's head shape (1, 4096, 5, 12) in float32 the
    backward of the blockwise attention keeps each step's carries and
    inputs only (the reference's ``jax.checkpoint`` per kv step), not its
    score and probability blocks: at most 64 MB where every step's
    blocks took 1402 MB."""
    cfg = tL.AttnConfig(d_model=60, n_heads=5, n_kv_heads=5, d_head=12)
    q, k, v = (_t(a).requires_grad_() for a in _blockwise_qkv())
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        o = tL._blockwise_attention(q, k, v, cfg, 12 ** -0.5, False)
    assert sum(saved) <= 64e6, f"{sum(saved) / 1e6:.1f} MB saved"
    o.sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))


@pytest.mark.parametrize("triangular", [False, True])
def test_blockwise_attention_gradients_match_reference(triangular):
    """Forward values and the gradients of q, k and v of the checkpointed
    block loop against the reference's ``_blockwise_attention`` under
    ``jax.grad`` (a fixed random cotangent).  The gradients are held in
    the float32 class (rtol 1e-5, atol 1e-5 * max|g|): the port's ``dv``
    (max |dv| 4.58) moves by up to 1.4e-6 with the number of torch threads
    (1, 4, 8), three float32 steps at its largest values, while the
    reference's does not move with XLA's; a ``dv`` off by 1e-4 of itself
    is 4.6e-4 off at its largest element, five times the bound there."""
    S = 3072
    cfg = tL.AttnConfig(d_model=24, n_heads=2, n_kv_heads=1, d_head=12)
    jcfg = jL.AttnConfig(d_model=24, n_heads=2, n_kv_heads=1, d_head=12)
    q, k, v = _blockwise_qkv(S, 2, 12, seed=3)
    k, v = k[:, :, :1], v[:, :, :1]
    ct = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)
    scale = 12 ** -0.5

    def jfn(q, k, v):
        o = jL._blockwise_attention(q, k, v, jcfg, scale, triangular, False)
        return (o * ct).sum(), o

    (_, jo), jg = jax.value_and_grad(jfn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    to = tL._blockwise_attention(tq, tk, tv, cfg, scale, triangular)
    (to * _t(ct)).sum().backward()
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), rtol=1e-5, atol=1e-6)
    for t, g, name in zip((tq, tk, tv), jg, "qkv"):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(g).max()), err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_and_prefill_match_reference(arch):
    jcfg, tcfg, jp, tp = lm_params(arch, seed=6)
    tok = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 12))
    assert_close(tT.forward(tp, tcfg, _t(tok)), jT.forward(jp, jcfg, jnp.asarray(tok)), "forward")
    got = tserve.make_prefill(tcfg)(tp, _t(tok))
    assert_close(got, jserve.make_prefill(jcfg)(jp, jnp.asarray(tok)), "prefill")


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_step_matches_reference(arch, flash, no_kernel):
    """B = 2 over a cache of 8 with prefilled history and ragged lengths
    (3, 6), four steps: logits and the whole cache against the reference
    after each.  Row 1 writes the last slot at step 1, and at steps 2 and
    3 its cache is full: the write is dropped, as the reference's
    ``.at[].set`` drops it.

    With a full cache the reference's flash path attends to
    ``cache_len + 1 - S_max`` zero keys of the padding that
    ``ops.flash_decode_attn`` adds (S = 8 padded to 512), which its
    non-flash path does not; the port reads only the S_max keys there is.
    So from step 2 the port's flash logits are held against the
    reference's non-flash step, and the reference's flash step is shown
    to differ from it (ROADMAP.md §3)."""
    jcfg, tcfg, jp, tp = lm_params(arch, seed=7)
    rng = np.random.default_rng(7)
    shape = (jcfg.n_layers, 2, 8, jcfg.n_kv_heads, jcfg.head_dim)
    k0 = rng.standard_normal(shape).astype(np.float32)
    v0 = rng.standard_normal(shape).astype(np.float32)
    lens = np.array([3, 6], np.int32)
    jc = {"k": jnp.asarray(k0), "v": jnp.asarray(v0), "len": jnp.asarray(lens)}
    tc = {"k": _t(k0), "v": _t(v0), "len": _t(lens)}
    for step in range(4):
        tok = jnp.asarray(rng.integers(0, jcfg.vocab, 2))
        before, jbefore = tc["k"][:, 1].clone(), np.asarray(jc["k"][:, 1])
        jl, jc_next = jT.decode_step(jp, jcfg, jc, tok, use_flash_kernel=False)
        if flash:
            jl_flash, _ = jT.decode_step(jp, jcfg, jc, tok, use_flash_kernel=True)
            if step < 2:
                jl = jl_flash
            else:  # the reference's padding quirk at a full cache
                assert np.abs(np.asarray(jl_flash[1]) - np.asarray(jl[1])).max() > 1e-3
        jc = jc_next
        tl, tc = tT.decode_step(tp, tcfg, tc, _t(tok), use_flash_kernel=flash)
        assert_close(tl, jl, f"logits step {step}")
        assert_close(tc["k"], jc["k"], f"k cache step {step}")
        assert_close(tc["v"], jc["v"], f"v cache step {step}")
        np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
        if step == 1:  # row 1 wrote slot 7, the last
            assert not torch.equal(tc["k"][:, 1, 7], before[:, 7])
        if step >= 2:  # row 1's cache is full: nothing written
            assert torch.equal(tc["k"][:, 1], before)
            np.testing.assert_array_equal(np.asarray(jc["k"][:, 1]), jbefore)


def test_decode_step_writes_the_cache_in_place():
    _, tcfg, _, tp = lm_params("smollm-360m", seed=8)
    cache = tT.init_kv_cache(tcfg, 2, 4, dtype=torch.float32, device=CPU)
    k = cache["k"]
    _, new = tT.decode_step(tp, tcfg, cache, torch.tensor([3, 4]))
    assert new["k"] is k and bool(k[:, :, 0].abs().sum() > 0) and bool((k[:, :, 1:] == 0).all())
    assert new["len"].tolist() == [1, 1] and cache["len"].tolist() == [0, 0]


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flash", [False, True])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_generate_greedy_matches_reference(arch, flash, no_kernel):
    """Greedy tokens equal to the reference's; the cache is bf16 under
    f32 weights on both sides, as ``generate`` makes it."""
    jcfg, tcfg, jp, tp = lm_params(arch, seed=9)
    prompt = np.random.default_rng(9).integers(0, jcfg.vocab, (2, 5))
    want = jserve.generate(jp, jcfg, jnp.asarray(prompt), 4, use_flash_kernel=flash)
    got = tserve.generate(tp, tcfg, _t(prompt), 4, use_flash_kernel=flash)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_batched_request_server_matches_reference():
    jcfg, tcfg, jp, tp = lm_params("qwen2.5-3b", seed=10)
    rng = np.random.default_rng(10)
    reqs = [rng.integers(1, jcfg.vocab, n) for n in (3, 6, 1)]
    want = jserve.batched_request_server(jp, jcfg, [jnp.asarray(r) for r in reqs], max_new=3)
    got = tserve.batched_request_server(tp, tcfg, [_t(r) for r in reqs], max_new=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert tserve.pad_requests([_t(r) for r in reqs])[2].tolist() == [0] * 5 + [int(reqs[2][0])]


def test_generate_samples_from_the_generator():
    """temperature > 0 draws from the torch.Generator given as ``key``: the
    same seed gives the same tokens, all in [0, vocab)."""
    _, tcfg, _, tp = lm_params("smollm-360m", seed=11)
    prompt = torch.tensor([[1, 2, 3], [4, 5, 6]])
    a = tserve.generate(tp, tcfg, prompt, 6, temperature=1.5, key=torch.Generator().manual_seed(1))
    b = tserve.generate(tp, tcfg, prompt, 6, temperature=1.5, key=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and torch.equal(a[:, :3], prompt)
    assert int(a.min()) >= 0 and int(a.max()) < tcfg.vocab


def test_launch_serve_main_on_the_cpu(capsys):
    tlaunch.main(["--arch", "smollm-360m", "--reduced", "--device", "cpu", "--batch", "2",
                  "--prompt-len", "4", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 7)" in out and "sample:" in out
    with pytest.raises(SystemExit):  # not an LM
        tlaunch.main(["--arch", "gcn-cora", "--reduced", "--device", "cpu"])


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run: python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_cuda_decode_step_flash_matches_plain(cuda, arch):
    """Each REDUCED config's decode on the card through the kernel against
    the same step without it, in float32 (no TF32)."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = treg.get(arch).reduced
    params = tT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                            dtype=torch.float32, device=cuda)
    logits = []
    for flash in (True, False):
        cache = tT.init_kv_cache(cfg, 3, 40, dtype=torch.float32, device=cuda)
        cache["len"] = torch.tensor([0, 17, 39], dtype=torch.int32, device=cuda)
        out = []
        for t in range(3):
            step, cache = tT.decode_step(params, cfg, cache,
                                         torch.tensor([t, 2 * t, 3 * t], device=cuda),
                                         use_flash_kernel=flash)
            out.append(step)
        logits.append(torch.stack(out))
    torch.cuda.synchronize()
    scale = float(logits[1].abs().max())
    torch.testing.assert_close(logits[0], logits[1], rtol=1e-5, atol=1e-5 * scale)
