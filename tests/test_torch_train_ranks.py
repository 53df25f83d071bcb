"""ZeRO-1 training across ``torch.distributed`` ranks, and checkpoints that re-shard.

smollm-360m and dcn-v2 at their REDUCED configs, through the launcher's
builders (``launch.train.make_lm_run`` / ``make_dcn_run`` with a
``(k, 1)`` ("data", "model") mesh) and its CLI.  Each world is one spawn
of gloo processes on the CPU (``spawn_ranks`` from ``test_torch_ranks.py``,
one torch thread each); the one-rank reference is a world-size-1 spawn,
so it runs at the same thread count (CPU matrix products may round
otherwise at another one).  Spawns: 4 ranks (train, save a checkpoint
with the state's specs), then 2 ranks (train, restore the 4-rank
checkpoint, resume, the CLI), then 1 rank (the ``n_micro`` references,
the restore onto one rank, the one-rank CLI).

Exactness: 2 ranks equal one rank at ``n_micro=2`` bit for bit in loss,
grad norm and every parameter and moment leaf after three steps (the
rank step's all-reduce ``g0 + g1`` is ``_accumulate``'s ``(0 + g0) + g1``;
AdamW is elementwise).  4 ranks against ``n_micro=4``: gloo's ring adds
the four parts in another order, so the loss is held to rtol 1e-5 and
the leaves to ``ZERO1_K4_ATOL`` (measured on this CPU: the losses and
grad norms equal or one float32 ulp apart, the leaves within 1.5e-8).  Each rank's
moments are its ``zero1_specs`` slice; a 4-rank checkpoint restores onto
2 ranks and onto 1 with the logical state equal bit for bit; a 2-rank
run resumed from its step-2 checkpoint equals the uninterrupted run.
"""
import numpy as np
import pytest
import torch.distributed as dist

from repro_torch._tree import flatten_with_paths
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import registry
from repro_torch.dist import shardings as SH
from repro_torch.launch import train as ttrain
from repro_torch.train import train_step as TS

from test_torch_ranks import spawn_ranks

ARCHS = ["smollm-360m", "dcn-v2"]
STEPS = 3
ZERO1_K4_ATOL = 1e-6


def _args(arch, n_micro=1, steps=STEPS):
    return ttrain.parser().parse_args([
        "--arch", arch, "--reduced", "--device", "cpu", "--steps", str(steps),
        "--batch", "8", "--seq", "16", "--n-micro", str(n_micro)])


def _np(tree) -> dict:
    return {p: t.detach().cpu().numpy().copy() for p, t in flatten_with_paths(tree)}


def _train(arch, n_micro, steps=STEPS, mesh=None):
    """``steps`` steps from the seed's parameters: (history, state, specs,
    (step_fn, batch_fn, the initial parameters))."""
    spec = registry.get(arch)
    make = ttrain.make_lm_run if spec.family == "lm" else ttrain.make_dcn_run
    args = _args(arch, n_micro, steps)
    params, step_fn, batch_fn = make(spec.reduced, args, mesh)
    state = TS.init_state(params)
    specs = None
    if mesh is not None:
        specs = ttrain.train_specs(spec.family, spec.reduced, params, mesh)
        state = SH.place(state, specs, mesh)
    state, hist = ttrain.train_loop(step_fn, batch_fn, state, 0, steps, log_every=100,
                                    log=lambda *a: None)
    return hist, state, specs, (step_fn, batch_fn, params)


def _metrics(hist):
    return [(h["loss"], h["grad_norm"], h["lr"]) for h in hist]


def rank_run(ckpt_root: str, cli_dir: str) -> dict:
    """What each rank of the 2- and 4-rank spawns computes."""
    k = dist.get_world_size()
    mesh = ttrain.data_mesh("cpu")
    out = {}
    for arch in ARCHS:
        hist, state, specs, (step_fn, batch_fn, params0) = _train(arch, 1, mesh=mesh)
        logical = SH.gather(state, specs, mesh)
        m_local = _np(state.opt.m)
        m_want = {p: SH.shard_of(t, sp, mesh).numpy()
                  for (p, t), sp in zip(flatten_with_paths(logical.opt.m),
                                        [s for _, s in flatten_with_paths(specs.opt.m)])}
        o = {"metrics": _metrics(hist), "logical": _np(logical), "m_local": m_local,
             "m_want": m_want,
             "m_specs": {p: SH.spec_to_json(s) for p, s in flatten_with_paths(specs.opt.m)}}
        if k == 4:
            ckpt.save(f"{ckpt_root}/{arch}", STEPS, state, specs, mesh=mesh)
        else:
            # the 4-rank checkpoint onto these ranks
            template = TS.init_state(logical.params)
            step, restored = ckpt.restore(f"{ckpt_root}/{arch}", device="cpu",
                                          template=template, mesh=mesh)
            o["restored_step"] = step
            o["restored_logical"] = _np(SH.gather(restored, specs, mesh))
            # a run stopped after its step-2 checkpoint, resumed for step 3
            run = ttrain.ResumableRun(f"{ckpt_root}/resume_{arch}",
                                      make_state=lambda: TS.init_state(params0), save_every=2,
                                      device="cpu", specs=specs, mesh=mesh)
            s0, st = run.restore_or_init()
            st, _ = ttrain.train_loop(step_fn, batch_fn, st, s0, 2, run, log=lambda *a: None)
            s2, st = run.restore_or_init()
            st, h3 = ttrain.train_loop(step_fn, batch_fn, st, s2, STEPS, log=lambda *a: None)
            o["resumed"] = {"from": s2, "metrics": _metrics(h3),
                            "logical": _np(SH.gather(st, specs, mesh))}
            o["cli"] = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu",
                                    "--steps", str(STEPS), "--batch", "8", "--seq", "16",
                                    "--n-micro", "2", "--log-every", "100",
                                    "--ckpt-dir", f"{cli_dir}/{arch}", "--ckpt-every", "2"])
        out[arch] = o
    return out


def one_rank_run(ckpt_root: str, cli_dir: str) -> dict:
    """The one-rank references (a world-size-1 spawn: no mesh)."""
    assert ttrain.data_mesh("cpu") is None
    out = {}
    for arch in ARCHS:
        o = {}
        for n_micro in (2, 4):
            hist, state, _, _ = _train(arch, n_micro)
            o[n_micro] = {"metrics": _metrics(hist), "logical": _np(state)}
        template = TS.init_state(state.params)
        o["restored_step"], restored = ckpt.restore(f"{ckpt_root}/{arch}", device="cpu",
                                                    template=template)
        o["restored_logical"] = _np(restored)
        o["cli"] = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu",
                                "--steps", str(STEPS), "--batch", "8", "--seq", "16",
                                "--n-micro", "2", "--log-every", "100"])
        out[arch] = o
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("zero1")
    ck, cli = str(root / "ckpt"), str(root / "cli")
    four = spawn_ranks(rank_run, 4, root, ck, cli)
    two = spawn_ranks(rank_run, 2, root, ck, cli)
    one = spawn_ranks(one_rank_run, 1, root, ck, cli)[0]
    return {4: four, 2: two, 1: one}


def _assert_leaves(got: dict, want: dict, what: str, atol: float = 0.0):
    assert got.keys() == want.keys(), what
    for p in want:
        if atol:
            np.testing.assert_allclose(got[p], want[p], rtol=0, atol=atol,
                                       err_msg=f"{what} {p}")
        else:
            np.testing.assert_array_equal(got[p], want[p], err_msg=f"{what} {p}")


@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_two_ranks_bit_identical_to_n_micro_2(runs, arch):
    want = runs[1][arch][2]
    for r, res in enumerate(runs[2]):
        got = res[arch]
        assert got["metrics"] == want["metrics"], f"rank {r}"
        _assert_leaves(got["logical"], want["logical"], f"rank {r}")


@pytest.mark.parametrize("arch", ARCHS)
def test_zero1_four_ranks_within_tolerance_of_n_micro_4(runs, arch):
    want = runs[1][arch][4]
    for r, res in enumerate(runs[4]):
        got = res[arch]
        for (gl, gn, glr), (wl, wn, wlr) in zip(got["metrics"], want["metrics"]):
            assert gl == pytest.approx(wl, rel=1e-5) and gn == pytest.approx(wn, rel=1e-5)
            assert glr == wlr
        _assert_leaves(got["logical"], want["logical"], f"rank {r}", atol=ZERO1_K4_ATOL)


@pytest.mark.parametrize("k", [2, 4])
@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_zero1_slice_of_the_moments(runs, arch, k):
    sharded = 0
    for r, res in enumerate(runs[k]):
        got = res[arch]
        _assert_leaves(got["m_local"], got["m_want"], f"k={k} rank {r}")
        for p, spec in got["m_specs"].items():
            whole = got["logical"][".opt/.m/" + p].size
            if spec and "data" in spec:
                sharded += 1
                assert got["m_local"][p].size * k == whole, f"k={k} rank {r} {p}"
            else:
                assert got["m_local"][p].size == whole, f"k={k} rank {r} {p}"
    assert sharded > 0  # zero1_specs shards some leaf of every arch


@pytest.mark.parametrize("arch", ARCHS)
def test_four_rank_checkpoint_restores_onto_two_and_one(runs, arch):
    saved = runs[4][0][arch]["logical"]
    for r, res in enumerate(runs[2]):
        assert res[arch]["restored_step"] == STEPS
        _assert_leaves(res[arch]["restored_logical"], saved, f"2 ranks, rank {r}")
    assert runs[1][arch]["restored_step"] == STEPS
    _assert_leaves(runs[1][arch]["restored_logical"], saved, "1 rank")


@pytest.mark.parametrize("arch", ARCHS)
def test_two_rank_resume_equals_uninterrupted(runs, arch):
    for r, res in enumerate(runs[2]):
        got = res[arch]
        assert got["resumed"]["from"] == 2
        assert got["resumed"]["metrics"] == got["metrics"][2:]
        _assert_leaves(got["resumed"]["logical"], got["logical"], f"rank {r}")


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_on_two_ranks_equals_one_rank_cli(runs, arch):
    want = runs[1][arch]["cli"]
    for r, res in enumerate(runs[2]):
        assert res[arch]["cli"] == want, f"rank {r}"


class _Mesh:
    """A stand-in for a ``(k, 1)`` mesh: ``_n_micro`` reads its size only."""

    def __init__(self, k):
        self.k = k

    def size(self):
        return self.k


@pytest.mark.parametrize("n_micro,k,want", [(1, 2, 1), (2, 2, 1), (4, 2, 2), (8, 4, 2),
                                            (3, 2, None), (2, 4, None), (6, 4, None)])
def test_n_micro_splits_over_the_ranks_or_exits(n_micro, k, want):
    """``--n-micro`` of the global batch becomes ``n_micro / k`` slices a
    rank; 1 stays 1 (each rank's part whole); a count that does not split
    over the k ranks ends the launcher, naming both."""
    args = _args("dcn-v2", n_micro)
    if want is None:
        with pytest.raises(SystemExit, match=f"--n-micro {n_micro} .* {k} ranks"):
            ttrain._n_micro(args, _Mesh(k))
    else:
        assert ttrain._n_micro(args, _Mesh(k)) == want
    assert ttrain._n_micro(args, None) == n_micro
