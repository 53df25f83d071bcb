"""The port's AdamW, clipping and WSD schedule against the JAX reference.

The same numpy trees (a nested dict with a list, float32 and bf16
leaves) and the same numpy gradients go through ``repro.optim.adamw``
and ``repro_torch.optim.adamw`` for several steps.  Tolerances: float32
moments and parameters rtol 1e-5, atol 1e-6 * max|reference| (the same
float32 operations, possibly fused differently); a bf16 parameter to
one bf16 ulp (rtol 2**-7), since a float32 difference in the last bit
can round it the other way; ``step`` and the schedule's float32 values
exactly.  Then the reference's own checks, held on the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro_torch import _tree
from repro_torch.optim import adamw as tadamw


def _t(x):
    return torch.from_numpy(np.array(x))


def random_tree(rng):
    return {
        "w": rng.standard_normal((7, 5)).astype(np.float32),
        "layers": [{"a": rng.standard_normal((3,)).astype(np.float32)},
                   {"a": rng.standard_normal((4, 2)).astype(np.float32)}],
        "emb": rng.standard_normal((6, 3)).astype(np.float32),
    }


def to_jax(tree, bf16=()):
    return jax.tree.map(jnp.asarray, tree) if not bf16 else {
        k: (jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), v) if k in bf16
            else jax.tree.map(jnp.asarray, v)) for k, v in tree.items()}


def to_torch(tree, bf16=()):
    return {k: _tree.tree_map(lambda a: _t(a).to(torch.bfloat16) if k in bf16 else _t(a), v)
            for k, v in tree.items()}


def assert_tree_close(got, want, what):
    gl, wl = _tree.leaves(got), jax.tree.leaves(want)
    assert len(gl) == len(wl), what
    for g, w in zip(gl, wl):
        w32 = np.asarray(w, np.float32)
        assert str(g.dtype).split(".")[1] == str(w.dtype), what
        g32 = g.float().numpy()
        if g.dtype == torch.bfloat16:
            np.testing.assert_allclose(g32, w32, rtol=2 ** -7, atol=0, err_msg=what)
        else:
            scale = max(float(np.abs(w32).max()), 1e-30)
            np.testing.assert_allclose(g32, w32, rtol=1e-5, atol=1e-6 * scale, err_msg=what)


@pytest.mark.parametrize("bf16", [(), ("emb",)])
@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_update_matches_reference_over_steps(bf16, wd):
    rng = np.random.default_rng(0)
    params = random_tree(rng)
    jp, tp = to_jax(params, bf16), to_torch(params, bf16)
    js, ts = jadamw.init(jp), tadamw.init(tp)
    assert ts.step.dtype == torch.int32 and ts.step.shape == ()
    assert all(m.dtype == torch.float32 for m in _tree.leaves(ts.m))
    lr_fn_j = jadamw.wsd_schedule(2, 3, 2, 1e-2)
    lr_fn_t = tadamw.wsd_schedule(2, 3, 2, 1e-2)
    for step in range(6):
        grads = random_tree(rng)
        jg, tg = to_jax(grads, bf16), to_torch(grads, bf16)
        jp, js = jadamw.update(js, jg, jp, lr_fn_j(js.step), weight_decay=wd)
        tp, ts = tadamw.update(ts, tg, tp, lr_fn_t(ts.step), weight_decay=wd)
        assert int(ts.step) == int(js.step) == step + 1
        assert_tree_close(ts.m, js.m, f"m at step {step}")
        assert_tree_close(ts.v, js.v, f"v at step {step}")
        assert_tree_close(tp, jp, f"params at step {step}")


@pytest.mark.parametrize("max_norm", [0.5, 1.0, 1e6])
def test_clip_and_global_norm_match_reference(max_norm):
    rng = np.random.default_rng(1)
    g = random_tree(rng)
    jc, jn = jadamw.clip_by_global_norm(to_jax(g), max_norm)
    tc, tn = tadamw.clip_by_global_norm(to_torch(g), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    np.testing.assert_allclose(float(tadamw.global_norm(to_torch(g))),
                               float(jadamw.global_norm(to_jax(g))), rtol=1e-6)
    assert_tree_close(tc, jc, "clipped")


def test_wsd_schedule_matches_reference():
    for args in ((10, 100, 50, 1.0, 0.1), (0, 5, 0, 3e-4, 0.1), (20, 7, 1, 3e-4, 0.5)):
        j, t = jadamw.wsd_schedule(*args), tadamw.wsd_schedule(*args)
        for s in range(0, 200, 3):
            want = np.float32(j(jnp.asarray(s, jnp.int32)))
            got = t(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32 and got.shape == ()
            assert np.float32(got) == want, (args, s)
            assert np.float32(t(s)) == want


# -- the reference's own checks (tests/test_substrate.py), on the port --------


def test_adamw_reduces_quadratic():
    params = {"w": torch.tensor([5.0, -3.0, 2.0])}
    state = tadamw.init(params)
    for _ in range(200):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(w ** 2), [w])
        params, state = tadamw.update(state, {"w": g}, params, lr=0.05, weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.1
    assert int(state.step) == 200


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 10.0)}
    clipped, norm = tadamw.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(1000.0))
    assert float(tadamw.global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)


def test_wsd_schedule_shape():
    lr = tadamw.wsd_schedule(10, 100, 50, 1.0, floor=0.1)
    assert float(lr(0)) == 0.0
    assert float(lr(10)) == pytest.approx(1.0)
    assert float(lr(50)) == pytest.approx(1.0)
    assert float(lr(110 + 50)) == pytest.approx(0.1)
