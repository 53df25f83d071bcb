"""The port's training launcher (``repro_torch.launch.train``) against the
reference's, and its checkpoint resume.

``make_lm_run`` and ``make_dcn_run`` at the REDUCED configs run five
steps in both packages from the same parameters (the reference's draws,
carried across with ``params_from_numpy``, since torch cannot reproduce
them) on the same batches.  Tolerance: the loss at each step to rtol
1e-5, atol 1e-5 * |reference loss|; grad norm and lr to rtol 1e-4 (the
float32 class of DESIGN.md §5).  The batch makers are bit-identical.  A
run killed right after its checkpoint at step 3 and resumed reproduces
the uninterrupted run's steps 4 and 5 bit for bit, under
``torch.use_deterministic_algorithms(True)`` (the embedding gradient's
accumulate otherwise adds in thread order on the CPU at larger batches).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.data import pipeline as jpipe
from repro.launch import train as jtrain
from repro_torch.configs import registry as treg
from repro_torch.data import pipeline as tpipe
from repro_torch.dist import fault_tolerance as tft
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tL
from repro_torch.train import train_step as tTS

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]


def args_for(arch, steps=5, batch=4, seq=16, device=CPU, **extra):
    argv = ["--arch", arch, "--reduced", "--steps", str(steps), "--batch", str(batch),
            "--seq", str(seq), "--device", device, "--log-every", "1"]
    for k, v in extra.items():
        argv += [f"--{k.replace('_', '-')}", str(v)]
    return ttrain.parser().parse_args(argv)


@pytest.mark.parametrize("arch,make", [("smollm-360m", "make_lm_run"),
                                       ("qwen3-moe-30b-a3b", "make_lm_run"),
                                       ("deepseek-moe-16b", "make_lm_run"),
                                       ("dcn-v2", "make_dcn_run")])
def test_runs_match_reference_over_five_steps(arch, make):
    args = args_for(arch, batch=8 if arch == "dcn-v2" else 4)
    jparams, jstep, jbatch = getattr(jtrain, make)(jreg.get(arch).reduced, args)
    tparams, tstep, tbatch = getattr(ttrain, make)(treg.get(arch).reduced, args)
    assert [tuple(t.shape) for t in jax.tree.leaves(tparams)] == \
        [a.shape for a in jax.tree.leaves(jparams)]
    tparams = tL.params_from_numpy(jax.tree.map(np.asarray, jparams), device=CPU)
    js, ts = jtrain.TS.init_state(jparams), tTS.init_state(tparams)
    for step in range(5):
        jb, tb = jbatch(step), tbatch(step)
        for k in jb:
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        want = float(jm["loss"])
        np.testing.assert_allclose(float(tm["loss"]), want, rtol=1e-5, atol=1e-5 * abs(want),
                                   err_msg=f"loss at step {step}")
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-4)


@pytest.mark.parametrize("step,batch,seq,vocab", [(0, 8, 32, 100), (7, 4, 5, 49152),
                                                  (3, 6, 16, 7)])
@pytest.mark.parametrize("n_hosts", [1, 2])
def test_token_batch_bit_identical(step, batch, seq, vocab, n_hosts):
    for host in range(n_hosts):
        got = tpipe.token_batch(1, step, batch, seq, vocab, host_id=host, n_hosts=n_hosts)
        want = jpipe.token_batch(1, step, batch, seq, vocab, host_id=host, n_hosts=n_hosts)
        for k in ("tokens", "labels"):
            assert got[k].dtype == want[k].dtype and got[k].shape == (batch // n_hosts, seq)
            np.testing.assert_array_equal(got[k], want[k])


def test_token_batch_deterministic_and_host_sharded():
    a = tpipe.token_batch(1, 7, 8, 32, 100)
    np.testing.assert_array_equal(a["tokens"], tpipe.token_batch(1, 7, 8, 32, 100)["tokens"])
    assert not np.array_equal(a["tokens"], tpipe.token_batch(1, 8, 8, 32, 100)["tokens"])
    h0 = tpipe.token_batch(1, 7, 8, 32, 100, host_id=0, n_hosts=2)
    h1 = tpipe.token_batch(1, 7, 8, 32, 100, host_id=1, n_hosts=2)
    assert h0["tokens"].shape == (4, 32)
    assert not np.array_equal(h0["tokens"], h1["tokens"])


class Killed(Exception):
    pass


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.mark.parametrize("arch", ["smollm-360m", "dcn-v2"])
def test_killed_run_resumes_to_the_uninterrupted_steps(arch, tmp_path, monkeypatch, capsys,
                                                       deterministic):
    """Five steps with a checkpoint every 3; a second run is killed just
    after the step-3 checkpoint is committed, then restarted with the same
    flags: it resumes at step 4 and its steps 4-5 equal the first run's."""
    argv = ["--arch", arch, "--reduced", "--steps", "5", "--batch", "4", "--seq", "16",
            "--device", CPU, "--log-every", "1", "--ckpt-every", "3"]
    whole = ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "whole")])
    assert [h["step"] for h in whole] == [0, 1, 2, 3, 4]

    saved = tft.ResumableRun.maybe_save

    def save_then_die(self, step, state):
        if saved(self, step, state):
            raise Killed(step)
        return False

    monkeypatch.setattr(tft.ResumableRun, "maybe_save", save_then_die)
    with pytest.raises(Killed, match="3"):
        ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "cut")])
    monkeypatch.setattr(tft.ResumableRun, "maybe_save", saved)
    capsys.readouterr()
    resumed = ttrain.main(argv + ["--ckpt-dir", str(tmp_path / "cut")])
    assert "[restore] resumed from step 3" in capsys.readouterr().out
    assert [h["step"] for h in resumed] == [3, 4]  # steps 4 and 5, counted from 1
    assert resumed == whole[3:]


def test_cli_runs_in_a_subprocess(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "smollm-360m", "--reduced",
         "--device", "cpu", "--steps", "3", "--log-every", "1", "--ckpt-dir",
         str(tmp_path / "ck"), "--ckpt-every", "2"],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert [ln.split()[:2] for ln in lines[:3]] == [["step", "0"], ["step", "1"], ["step", "2"]]
    assert all(" loss " in ln and " gnorm " in ln and " lr " in ln and "s/step)" in ln
               for ln in lines[:3])
    assert lines[-1].startswith("done: 3 steps in ")
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_000000002"]


@pytest.mark.parametrize("arch", ["gcn-cora", "schnet", "graphcast"])
def test_gnn_family_exits_with_the_reference_message(arch):
    with pytest.raises(SystemExit, match="use examples/train_gnn.py for the GNN family"):
        ttrain.main(["--arch", arch, "--reduced", "--device", CPU])


def test_launcher_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        ttrain.main(["--arch", "smollm-360m", "--reduced", "--steps", "1"])
