"""The port's checkpoints and fault-tolerance policies, and checkpoints
crossing between the two packages.

First the reference's own checks (tests/test_substrate.py), held on the
port: roundtrip, an uncommitted step ignored, async GC, ResumableRun
resuming, the heartbeat and the straggler policy (whose verdicts must
equal the reference's on the same durations).  Then checkpoints of a
REDUCED-smollm ``TrainState`` after two AdamW steps written by one
package and restored by the other.  Every restore is compared bit for
bit (``assert_array_equal`` on the bits, dtype included).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import smollm_360m as jsmol
from repro.data import pipeline as jpipe
from repro.dist import fault_tolerance as jft
from repro.models import transformer as jT
from repro.optim import adamw as jadamw
from repro.train import train_step as jTS
from repro_torch import _tree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.dist.fault_tolerance import HeartbeatMonitor, ResumableRun, StragglerPolicy
from repro_torch.models import layers as tL
from repro_torch.train import train_step as tTS

CPU = "cpu"


def bits(x) -> np.ndarray:
    """A leaf as (dtype name, raw bytes view) for bit-for-bit comparison."""
    if torch.is_tensor(x):
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.view(torch.int16).numpy()
        return str(x.numpy().dtype), x.numpy()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16" or a.dtype == np.dtype("V2"):
        return "bfloat16", a.view(np.int16)
    return str(a.dtype), a


def assert_bits_equal(got, want, what=""):
    (gd, g), (wd, w) = bits(got), bits(want)
    assert gd == wd, (what, gd, wd)
    assert g.shape == w.shape, (what, g.shape, w.shape)
    np.testing.assert_array_equal(g, w, err_msg=what)


# -- the reference's substrate checks, on the port -----------------------------


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(10, dtype=torch.float32), "b": {"c": torch.ones((3, 4))},
            "s": torch.tensor(7, dtype=torch.int32)}
    ckpt.save(str(tmp_path), 5, tree)
    assert ckpt.list_steps(str(tmp_path)) == [5] and ckpt.latest_step(str(tmp_path)) == 5
    step, restored = ckpt.restore(str(tmp_path), device=CPU, template=tree)
    assert step == 5
    for k in ("a", "s"):
        assert_bits_equal(restored[k], tree[k], k)
    assert_bits_equal(restored["b"]["c"], tree["b"]["c"])
    _, flat = ckpt.restore(str(tmp_path), device=CPU)
    assert sorted(flat) == ["['a']", "['b']/['c']", "['s']"]


def test_checkpoint_uncommitted_ignored(tmp_path):
    tree = {"x": torch.zeros(3)}
    p = ckpt.save(str(tmp_path), 1, tree)
    os.remove(os.path.join(p, "COMMITTED"))
    assert ckpt.list_steps(str(tmp_path)) == []
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), device=CPU, template=tree)


def test_async_checkpointer_gc(tmp_path):
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    tree = {"x": torch.arange(5)}
    for s in [10, 20, 30, 40]:
        saver.save_async(s, tree)
    saver.wait()
    assert ckpt.list_steps(str(tmp_path)) == [30, 40]
    assert len(saver.saved) == 4


def test_async_checkpointer_takes_a_consistent_cut(tmp_path):
    """The host copy is taken before save_async returns: a leaf changed
    in place afterwards does not reach the file."""
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=3)
    x = torch.arange(1 << 16, dtype=torch.float32)
    saver.save_async(1, {"x": x})
    x.fill_(-1.0)
    saver.wait()
    _, r = ckpt.restore(str(tmp_path), device=CPU, template={"x": x})
    assert torch.equal(r["x"], torch.arange(1 << 16, dtype=torch.float32))


def test_resumable_run_resumes(tmp_path):
    make = lambda: {"w": torch.zeros(4)}  # noqa: E731
    run = ResumableRun(str(tmp_path), make, save_every=10, device=CPU)
    step0, state = run.restore_or_init()
    assert step0 == 0
    state = {"w": torch.full((4,), 7.0)}
    assert not run.maybe_save(5, state) and not run.maybe_save(0, state)
    assert run.maybe_save(10, state)
    run.finish()
    run2 = ResumableRun(str(tmp_path), make, save_every=10, device=CPU)
    step1, state1 = run2.restore_or_init()
    assert step1 == 10
    np.testing.assert_array_equal(state1["w"].numpy(), 7.0 * np.ones(4))
    assert ResumableRun(None, make).restore_or_init()[0] == 0


def test_heartbeat_monitor():
    hb = HeartbeatMonitor(n_hosts=3, timeout_s=10)
    now = 100.0
    hb.beat(0, now), hb.beat(1, now), hb.beat(2, now)
    assert hb.dead_hosts(now + 5) == []
    hb.beat(0, now + 12), hb.beat(1, now + 12)
    assert hb.dead_hosts(now + 15) == [2]


def test_straggler_policy_accepts_and_reassigns():
    sp = StragglerPolicy(n_shards=8, min_shards=6, deadline_s=10, strikes_out=2)
    r1 = sp.step({s: (30.0 if s == 7 else 1.0) for s in range(8)})
    assert r1["accepted"] and r1["late"] == [7]
    assert r1["grad_scale"] == pytest.approx(8 / 7)
    r2 = sp.step({s: (30.0 if s == 7 else 1.0) for s in range(8)})
    assert r2["reassign"] == [7]
    r3 = sp.step({s: 30.0 for s in range(8)})
    assert not r3["accepted"] and r3["grad_scale"] == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_straggler_and_heartbeat_verdicts_equal_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 10))
    args = (n, int(rng.integers(1, n + 1)), 5.0, int(rng.integers(1, 4)))
    ours, theirs = StragglerPolicy(*args), jft.StragglerPolicy(*args)
    hb, jhb = HeartbeatMonitor(n, 3.0), jft.HeartbeatMonitor(n, 3.0)
    for t in range(40):
        durations = {s: float(d) for s, d in enumerate(rng.exponential(3.0, n))}
        assert ours.step(durations) == theirs.step(durations)
        for h in rng.choice(n, int(rng.integers(0, n + 1)), replace=False):
            hb.beat(int(h), float(t)), jhb.beat(int(h), float(t))
        assert hb.dead_hosts(t + 0.5) == jhb.dead_hosts(t + 0.5)


# -- across the packages -------------------------------------------------------


def reference_state(n_steps=2):
    """The reference's REDUCED-smollm TrainState after ``n_steps`` jitted
    steps (float32 params and moments, an int32 step)."""
    cfg = jsmol.REDUCED
    params = jT.init_params(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    step = jax.jit(jTS.make_train_step(jTS.lm_loss(cfg), jadamw.wsd_schedule(1, 10, 2, 1e-3)))
    state = jTS.init_state(params)
    for s in range(n_steps):
        b = jpipe.token_batch(0, s, 4, 16, cfg.vocab)
        state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()})
    return state


def port_template(jstate):
    """A fresh port TrainState of the reference's parameter structure."""
    params = tL.params_from_numpy(jax.tree.map(lambda a: np.zeros_like(a), jstate.params),
                                  device=CPU)
    return tTS.init_state(params)


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    js = reference_state()
    jckpt.save(str(tmp_path), 2, js)
    step, ts = ckpt.restore(str(tmp_path), device=CPU, template=port_template(js))
    assert step == 2 and isinstance(ts, tTS.TrainState)
    assert ts.opt.step.dtype == torch.int32 and int(ts.opt.step) == 2
    tflat = _tree.flatten_with_paths(ts)
    jpaths, jleaves, _ = jckpt._flatten_with_paths(js)
    assert [p for p, _ in tflat] == jpaths
    for (path, t), j in zip(tflat, jleaves):
        assert_bits_equal(t, np.asarray(j), path)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    js = reference_state()
    ts = tL.params_from_numpy(jax.tree.map(np.asarray, js.params), device=CPU)
    ts = tTS.TrainState(ts, tTS.adamw.AdamWState(
        torch.tensor(int(js.opt.step), dtype=torch.int32),
        tL.params_from_numpy(jax.tree.map(np.asarray, js.opt.m), device=CPU),
        tL.params_from_numpy(jax.tree.map(np.asarray, js.opt.v), device=CPU)))
    ckpt.save(str(tmp_path), 2, ts)
    template = jTS.init_state(jax.tree.map(jnp.zeros_like, js.params))
    step, restored = jckpt.restore(str(tmp_path), template=template)
    assert step == 2
    for (path, t), r in zip(_tree.flatten_with_paths(ts), jax.tree.leaves(restored)):
        assert_bits_equal(t, np.asarray(r), path)


def test_bf16_leaves_restore_bit_exact(tmp_path):
    """A bf16 leaf written by the port restores into the port bit for bit;
    a reference bf16 leaf restores into the port bit for bit; and the
    reference restores the port's bf16 leaf as the same two-byte patterns
    it restores its own as."""
    x = torch.randn(33, 7, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    tree = {"w": x, "n": torch.ones(3)}
    ckpt.save(str(tmp_path / "port"), 1, tree)
    _, got = ckpt.restore(str(tmp_path / "port"), device=CPU, template=tree)
    assert got["w"].dtype == torch.bfloat16
    assert_bits_equal(got["w"], x)
    jtree = {"w": jnp.asarray(x.float().numpy(), jnp.bfloat16), "n": jnp.ones(3, jnp.float32)}
    jckpt.save(str(tmp_path / "ref"), 1, jtree)
    _, from_ref = ckpt.restore(str(tmp_path / "ref"), device=CPU, template=tree)
    assert_bits_equal(from_ref["w"], x)
    _, j_port = jckpt.restore(str(tmp_path / "port"), template=jtree)
    _, j_ref = jckpt.restore(str(tmp_path / "ref"), template=jtree)
    assert j_port["w"].dtype.itemsize == j_ref["w"].dtype.itemsize == 2
    assert_bits_equal(np.asarray(j_port["w"]), np.asarray(j_ref["w"]))


def test_restore_defaults_to_cuda(tmp_path, monkeypatch):
    ckpt.save(str(tmp_path), 1, {"x": torch.zeros(2)})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        ckpt.restore(str(tmp_path))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run: python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_roundtrip_and_async_cut(tmp_path, cuda):
    """Card tensors (float32, bf16, an int32 step) save and restore onto
    the card bit for bit, and ``save_async``'s host copy is taken before
    it returns."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    tree = {"w": torch.randn(300, 7, generator=gen, device=cuda),
            "h": torch.randn(33, generator=gen, device=cuda).to(torch.bfloat16),
            "step": torch.tensor(9, dtype=torch.int32, device=cuda)}
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=1)
    saver.save_async(9, tree)
    want = {k: v.clone() for k, v in tree.items()}
    tree["w"].fill_(0.0)
    saver.wait()
    step, got = ckpt.restore(str(tmp_path), device=cuda, template=tree)
    assert step == 9
    for k in want:
        assert got[k].device.type == "cuda" and got[k].dtype == want[k].dtype
        assert_bits_equal(got[k].cpu(), want[k].cpu(), k)


# -- specs and re-sharding across the packages ----------------------------------


class FakeMesh:
    """A mesh that is only its axis sizes: what both packages' sharding
    rules read."""

    def __init__(self, **sizes):
        self.shape = sizes


def _specs_both(js, mesh):
    """The ZeRO-1 TrainState specs of ``js`` by each package's own rules."""
    from repro.launch import cells as jcells
    from repro_torch.launch import cells as tcells

    jspecs = jcells._lm_state_specs(jsmol.REDUCED, mesh, js.params)
    tparams = tL.params_from_numpy(jax.tree.map(np.asarray, js.params), device=CPU)
    return jspecs, tcells._lm_state_specs(jsmol.REDUCED, mesh, tparams)


def _port_state(js):
    return tTS.TrainState(
        tL.params_from_numpy(jax.tree.map(np.asarray, js.params), device=CPU),
        tTS.adamw.AdamWState(torch.tensor(int(js.opt.step), dtype=torch.int32),
                             tL.params_from_numpy(jax.tree.map(np.asarray, js.opt.m), device=CPU),
                             tL.params_from_numpy(jax.tree.map(np.asarray, js.opt.v), device=CPU)))


def _manifest_specs(d, step):
    import json

    with open(os.path.join(d, f"step_{step:09d}", "manifest.json")) as f:
        return [leaf["spec"] for leaf in json.load(f)["leaves"]]


@pytest.mark.parametrize("axes", [{"data": 2, "model": 1}, {"pod": 2, "data": 2, "model": 1}])
def test_save_writes_the_reference_spec_form(tmp_path, axes):
    """The same state and the same specs (each package's rules) give the
    same manifest specs from both packages: ``list(P)``, a tuple entry as
    a list; without specs every leaf's spec is null, as before."""
    js = reference_state()
    jspecs, tspecs = _specs_both(js, FakeMesh(**axes))
    jckpt.save(str(tmp_path / "ref"), 2, js, jspecs)
    ckpt.save(str(tmp_path / "port"), 2, _port_state(js), tspecs)
    got, want = _manifest_specs(tmp_path / "port", 2), _manifest_specs(tmp_path / "ref", 2)
    assert got == want
    assert any(s and any(e in ("data", ["pod", "data"]) for e in s) for s in got)
    ckpt.save(str(tmp_path / "plain"), 2, _port_state(js))
    assert set(map(str, _manifest_specs(tmp_path / "plain", 2))) == {"None"}


def test_port_checkpoint_with_specs_restores_in_the_reference_on_a_mesh(tmp_path):
    """A port checkpoint with ZeRO-1 specs restores in the reference with
    ``restore(mesh=<1x1 mesh>, target_specs=...)``: values bit for bit,
    each leaf's ``sharding.spec`` the one written."""
    from jax.sharding import PartitionSpec as jP

    js = reference_state()
    _, tspecs = _specs_both(js, FakeMesh(data=2, model=1))
    ts = _port_state(js)
    ckpt.save(str(tmp_path), 2, ts, tspecs)
    written = _manifest_specs(tmp_path, 2)
    template = jTS.init_state(jax.tree.map(jnp.zeros_like, js.params))
    treedef = jax.tree_util.tree_structure(template)
    target = jax.tree_util.tree_unflatten(
        treedef, [jP(*(tuple(e) if isinstance(e, list) else e for e in s)) for s in written])
    mesh1 = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"))
    step, restored = jckpt.restore(str(tmp_path), mesh=mesh1, target_specs=target,
                                   template=template)
    assert step == 2
    for (path, t), r, s in zip(_tree.flatten_with_paths(ts), jax.tree.leaves(restored),
                               written):
        assert_bits_equal(t, np.asarray(r), path)
        assert r.sharding.spec == jP(*(tuple(e) if isinstance(e, list) else e for e in s))


def restore_on_ranks(directory: str) -> dict:
    """One rank of a 2-rank spawn: the checkpoint placed by its manifest's
    specs on a (2, 1) mesh; this rank's leaves and coordinate."""
    from repro_torch.launch import mesh as mesh_lib

    mesh = mesh_lib.rank_mesh((2, 1), ("data", "model"), device="cpu")
    step, flat = ckpt.restore(directory, device=CPU, mesh=mesh)
    return {"step": step, "coord": mesh.get_coordinate()[0],
            "leaves": {p: t.numpy() for p, t in flat.items()}}


def test_reference_checkpoint_with_specs_restores_on_two_port_ranks(tmp_path):
    """A reference checkpoint saved with its ZeRO-1 specs restores into
    the port on 2 gloo ranks: each rank holds its slice of every sharded
    leaf (its half along the spec's "data" dim) and the whole of the
    rest."""
    from test_torch_ranks import spawn_ranks

    js = reference_state()
    jspecs, _ = _specs_both(js, FakeMesh(data=2, model=1))
    jckpt.save(str(tmp_path / "ck"), 2, js, jspecs)
    paths, full, _ = jckpt._flatten_with_paths(js)
    written = _manifest_specs(tmp_path / "ck", 2)
    res = spawn_ranks(restore_on_ranks, 2, tmp_path, str(tmp_path / "ck"))
    sliced = 0
    for r, out in enumerate(res):
        assert out["step"] == 2 and out["coord"] == r
        for p, a, spec in zip(paths, full, written):
            a = np.asarray(a)
            want = a
            if spec and "data" in spec:
                d = spec.index("data")
                c = a.shape[d] // 2
                want = np.take(a, range(r * c, (r + 1) * c), axis=d)
                sliced += 1
            assert_bits_equal(out["leaves"][p], want, f"rank {r} {p}")
    assert sliced > 0
