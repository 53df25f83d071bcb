"""The port's GraphSAGE streaming trainer (``repro_torch.launch.train_gnn``)
against a loop built from the reference's own modules.

The reference loop is ``examples/train_gnn.py``'s, at n = 512, m = 4000,
12 steps, a batch of 32 and an insert every 4 steps, from the same
parameters (the reference's draws, carried across with
``params_from_numpy``).  Tolerance: per-step loss and the final
parameters to rtol 1e-4 (the float32 class of DESIGN.md §5); the sampled
seeds and masks are equal at every step.  A run killed after step 6 and
resumed from its checkpoint reproduces the uninterrupted run's steps and
parameters bit for bit.
"""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat_graph as jfg
from repro.data.pipeline import NeighborSampler as JSampler
from repro.data.pipeline import power_law_graph as j_power_law_graph
from repro.dist.fault_tolerance import ResumableRun as JRun
from repro.models.gnn import graphsage as jsage
from repro.optim import adamw as jadamw
from repro.train import train_step as jTS
from repro_torch import _tree
from repro_torch.launch import train_gnn
from repro_torch.models import layers as tL

ROOT = Path(__file__).resolve().parents[1]
STEPS, N, M, BATCH, EVERY = 12, 512, 4000, 32, 4


def _example():
    """``examples/train_gnn.py`` as a module (its ``_eval_acc``)."""
    spec = importlib.util.spec_from_file_location("_ref_train_gnn",
                                                  ROOT / "examples" / "train_gnn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def args_for(ckpt_dir, device="cpu", ckpt_every=100, steps=STEPS):
    return train_gnn.parser().parse_args([
        "--steps", str(steps), "--batch", str(BATCH), "--n", str(N), "--m", str(M),
        "--d-feat", "16", "--d-hidden", "32", "--classes", "8",
        "--stream-every", str(EVERY), "--ckpt-dir", str(ckpt_dir),
        "--ckpt-every", str(ckpt_every), "--device", device,
    ])


def reference_run(args):
    """``examples/train_gnn.py``'s loop on the reference's modules:
    per-step losses, the draws of every step and the final parameters."""
    offsets, nbrs = j_power_law_graph(args.n, args.m, seed=0)
    edges = np.stack([np.repeat(np.arange(args.n), np.diff(offsets)), nbrs], 1)
    graph = jfg.from_edges(args.n, edges)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((args.n, args.d_feat)).astype(np.float32)
    w_true = rng.standard_normal((args.d_feat, args.classes))
    labels = (feats @ w_true).argmax(1)
    params = jsage.init(jax.random.PRNGKey(0), args.d_feat, args.d_hidden, args.classes)
    step_fn = jax.jit(jTS.make_train_step(
        jTS.sage_sampled_loss(), jadamw.wsd_schedule(20, args.steps, 50, 1e-2)))
    run = JRun(None, make_state=lambda: jTS.init_state(params), save_every=100)
    _, state = run.restore_or_init()
    losses, draws = [], []
    for step in range(args.steps):
        if step % args.stream_every == 0 and step > 0:
            new = np.stack([rng.integers(0, args.n, 512), rng.integers(0, args.n, 512)], 1)
            graph = jfg.insert_edges_host(graph, new)
        csr_off = np.asarray(graph.offsets)
        csr_nbr = np.asarray(graph.keys)[: int(graph.m)] & 0xFFFFFFFF
        sampler = JSampler(csr_off, csr_nbr, feats)
        sb = sampler.sample_batch(0, step, args.batch, tuple(args.fanout))
        draws.append(sb)
        batch = {
            "x_self": jnp.asarray(sb["x_self"]),
            "neigh_feats": [jnp.asarray(f) for f in sb["neigh_feats"]],
            "neigh_masks": [jnp.asarray(m) for m in sb["neigh_masks"]],
            "labels": jnp.asarray(labels[sb["seeds"]]),
        }
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
    return {"params": params, "state": state, "losses": losses, "draws": draws,
            "sampler": sampler, "labels": labels}


@pytest.fixture(scope="module")
def ref():
    return reference_run(args_for(None))


def _ported(params):
    return tL.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")


def test_draws_match_reference_at_every_step(ref):
    """The live snapshot's sampler gives the reference's seeds, ids and
    masks at every step, through the inserts."""
    args = args_for(None)
    stream, _ = train_gnn.make_stream(args, "cpu")
    for step in range(STEPS):
        stream.advance(step)
        got = stream.sampler.sample_ids(0, step, BATCH, tuple(args.fanout))
        want = ref["draws"][step]
        np.testing.assert_array_equal(got["seeds"].numpy(), want["seeds"])
        for g, w in zip(got["neigh_masks"], want["neigh_masks"]):
            np.testing.assert_array_equal(g.numpy(), w)
        feats = stream.feats.numpy()
        for ids, w in zip(got["ids"], want["neigh_feats"]):
            np.testing.assert_array_equal(feats[ids.numpy()], w)
    assert stream.rebuilds == 1 + (STEPS - 1) // EVERY


def test_trainer_matches_reference_over_twelve_steps(ref, tmp_path):
    out = train_gnn.train(args_for(tmp_path), params=_ported(ref["params"]), log=lambda s: None)
    got = [h["loss"] for h in out["history"]]
    np.testing.assert_allclose(got, ref["losses"], rtol=1e-4)
    jleaves = jax.tree.leaves(ref["state"].params)
    tleaves = _tree.leaves(out["state"].params)
    assert len(jleaves) == len(tleaves)
    for t, j in zip(tleaves, jleaves):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4 * float(np.abs(np.asarray(j)).max()))
    assert out["stream"].rebuilds == 1 + (STEPS - 1) // EVERY
    assert int(out["stream"].graph.m) == int(ref["sampler"].nbrs.size)


def test_eval_acc_matches_reference(ref):
    args = args_for(None)
    stream, labels = train_gnn.make_stream(args, "cpu")
    for step in range(STEPS):
        stream.advance(step)
    got = train_gnn.eval_acc(_ported(ref["state"].params), stream.sampler, labels, args)
    want = _example()._eval_acc(ref["state"].params, ref["sampler"], ref["labels"], args)
    assert got == pytest.approx(want, abs=1.0 / 512)


def test_killed_run_resumes_to_the_uninterrupted_steps(ref, tmp_path):
    params = _ported(ref["params"])
    quiet = lambda s: None  # noqa: E731
    whole = train_gnn.train(args_for(tmp_path / "whole"), params=params, log=quiet)
    ckpt = tmp_path / "killed"
    first = train_gnn.train(args_for(ckpt, ckpt_every=3), params=params, log=quiet,
                            stop_after=6)
    assert [h["step"] for h in first["history"]] == list(range(7))
    resumed = train_gnn.train(args_for(ckpt, ckpt_every=3), params=params, log=quiet)
    assert resumed["start"] == 6
    assert [h["step"] for h in resumed["history"]] == list(range(6, STEPS))
    for h, w in zip(resumed["history"], whole["history"][6:]):
        assert h["loss"] == w["loss"] and h["grad_norm"] == w["grad_norm"]
    for t, w in zip(_tree.leaves(resumed["state"]), _tree.leaves(whole["state"])):
        assert torch.equal(t, w)
    assert torch.equal(resumed["stream"].graph.keys, whole["stream"].graph.keys)


def test_cli_runs_on_the_cpu(tmp_path, capsys):
    train_gnn.main(["--steps", "3", "--batch", "16", "--n", "256", "--m", "2000",
                    "--d-feat", "8", "--d-hidden", "16", "--classes", "4",
                    "--stream-every", "2", "--ckpt-dir", str(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "step    0" in out and "done. final accuracy" in out


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run: python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_sampler_rebuilt_only_on_a_new_snapshot(cuda, tmp_path):
    """On the card the sampler is built once per snapshot, and the
    batches equal the ones of a sampler built afresh at every step."""
    from repro_torch.data.pipeline import NeighborSampler

    args = args_for(tmp_path, device="cuda")
    stream, _ = train_gnn.make_stream(args, cuda)
    for step in range(STEPS):
        stream.advance(step)
        got = stream.sampler.sample_ids(0, step, BATCH, tuple(args.fanout))
        g = stream.graph
        fresh = NeighborSampler(g.offsets, g.keys[: int(g.m)] & 0xFFFFFFFF, stream.feats)
        want = fresh.sample_ids(0, step, BATCH, tuple(args.fanout))
        assert torch.equal(got["seeds"], want["seeds"])
        for a, b in zip(got["ids"] + got["neigh_masks"], want["ids"] + want["neigh_masks"]):
            assert torch.equal(a, b)
    assert stream.rebuilds == 1 + (STEPS - 1) // EVERY
