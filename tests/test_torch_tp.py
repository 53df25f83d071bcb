"""The cells' model-axis layouts with values, across ``torch.distributed``
ranks: tensor-parallel training, prefill and decode, vocab-sharded
DCN-v2 tables, checkpoints that re-shard.

Each world is one spawn of gloo processes on the CPU (``spawn_ranks``
from ``test_torch_ranks.py``, one torch thread each), every case inside:
4 ranks run the (2, 2) and (1, 4) ("data", "model") meshes (and (4, 1)
for the checkpoint chain), 2 ranks the (1, 2) mesh, and a world-size-1
spawn the one-rank answers, with no mesh.  The three spawns run side by
side while this process runs the reference's one-device jitted
functions.  All take the same seeded numpy inputs: the reference's
parameters (``params_from_numpy``) and its numpy batches.

Cases: qwen2.5-3b and smollm-360m REDUCED (qwen's 2 kv heads do not
divide the (1, 4) mesh's model axis, so its kv-group view reshards;
smollm's 5 heads divide none, so its attention stays replicated while
its MLP and vocab shard) and dcn-v2 REDUCED with ``vocab_per_field``
2048 (test-only: the rule shards a table of at least 1024 rows, and
REDUCED has 1000).  Two train steps at ``n_micro`` 2 of the global
batch; ``global_norm`` of the parameters; prefill logits; ``generate``'s
greedy tokens on a cache sharded on the kv heads (qwen on (1, 2) and
(2, 2), the latter with the batch over the data axis too) and on the
sequence (smollm everywhere, qwen on (1, 4)), and flash decode on both, each
rank's launch on a sequence-sharded cache combined with the others' by
their log-sum-exps; DCN-v2 serve and retrieval; the
checkpoint chain (2, 2) -> (4, 1) -> (1, 1) -> (1, 2).  The 4-rank spawn
saves the (2, 2) state and runs the (4, 1) link itself; the (1, 1) and
(1, 2) links run in two short spawns started one after the other once
the first three have returned, so no spawn waits on another's output
inside its deadline (``DEADLINE_S``: at least three times each spawn's
time beside five heavy test files under ``-n 6``).

Tolerances (float32; the sharded products and reductions add in another
order): against one rank, losses and grad norms rtol ``RTOL_ONE`` and
every leaf rtol ``RTOL_ONE`` with atol ``RTOL_ONE`` * max|leaf|; against
the reference, the float32 class of ``test_torch_train_step`` (rtol
1e-4, atol 1e-4 * max|leaf|; losses rtol 1e-5).  A parameter leaf's
atol is at least ``STEP_ATOL``, 1e-3 of the learning rate summed over
the steps: AdamW's normalised step moves an element by about lr however
small its gradient, so an element with a small gradient carries that
gradient's larger relative rounding error at the size of lr (measured on
this CPU: qwen's key bias ``bk``, gradients within 4e-9 of one rank's on
(1, 2), leaves within 1.6e-6 of one rank's and 7.2e-7 of the
reference's, against a summed lr of 3e-3; every other leaf within
atol ``RTOL_ONE`` * max|leaf|).  Logits and scores atol ``ATOL_OUT`` *
max|want|; tokens and retrieval ids exactly; the checkpoint chain bit
for bit.
"""
import concurrent.futures
import contextlib
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as jreg
from repro.data import pipeline as jpipe
from repro.models import transformer as jT
from repro.models.recsys import dcn_v2 as jdcn
from repro.optim import adamw as jadamw
from repro.serve import decode as jserve
from repro.train import train_step as jTS
from repro_torch._tree import flatten_with_paths, leaves
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import registry
from repro_torch.dist import shardings as SH
from repro_torch.dist import spmd
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tL
from repro_torch.models import transformer as tT
from repro_torch.models.recsys import dcn_v2 as tdcn
from repro_torch.optim import adamw
from repro_torch.serve import decode as tserve
from repro_torch.train import train_step as TS

from test_torch_ranks import spawn_ranks
from test_torch_train_step import LR

LM_ARCHS = ["qwen2.5-3b", "smollm-360m"]
ARCHS = LM_ARCHS + ["dcn-v2"]
MESHES = {4: [(2, 2), (1, 4)], 2: [(1, 2)]}
ALL_MESHES = [(1, 2), (2, 2), (1, 4)]
STEPS, N_MICRO = 2, 2  # n_micro of the global batch
LM_B, LM_S = 8, 16
PROMPT_B, PROMPT_S, NEW = 4, 4, 4  # a cache of 8 positions splits over 2 and 4 ranks
DCN_VOCAB, DCN_B, DCN_CAND, TOP_K = 2048, 16, 64, 8
RTOL_ONE = 1e-5
ATOL_OUT = 1e-5
# lr at steps 0 and 1 of the schedule: 0 (warmup) and the peak
STEP_ATOL = 1e-3 * LR["peak_lr"]
# seconds a spawn may take: tp4 and tp2 the 4- and 2-rank spawns, one the
# world-size-1 answers, c11 and c12 the chain's (1, 1) and (1, 2) links.
# Each is at least three times the spawn's time beside five heavy test
# files under -n 6 on an 8-core host (323.7, 185.6, 26.4, 8.4 and 15.4 s;
# alone 119.7, 61.4, 9.4, 8.2 and 14.4 s).
DEADLINE_S = {"tp4": 1000, "tp2": 600, "one": 240, "c11": 90, "c12": 90}


# ---------------------------------------------------------------------------
# the inputs, made once here from seeds, and the reference's answers
# ---------------------------------------------------------------------------


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def make_inputs() -> dict:
    out = {}
    for i, arch in enumerate(LM_ARCHS):
        cfg = jreg.get(arch).reduced
        out[arch] = {
            "params": _np(jT.init_params(jax.random.PRNGKey(i), cfg, dtype=jnp.float32)),
            "batches": [jpipe.token_batch(i, s, LM_B, LM_S, cfg.vocab) for s in range(STEPS)],
            "prompt": jpipe.token_batch(9, 0, PROMPT_B, PROMPT_S, cfg.vocab)["tokens"],
        }
    c = jreg.get("dcn-v2").reduced
    kw = dict(n_dense=c.n_dense, n_sparse=c.n_sparse, embed_dim=c.embed_dim,
              vocab_per_field=DCN_VOCAB, n_cross=c.n_cross, mlp_dims=c.mlp_dims)
    q = jpipe.recsys_batch(7, 0, 1, c.n_dense, c.n_sparse, DCN_VOCAB)
    out["dcn-v2"] = {
        "params": _np(jdcn.init(jax.random.PRNGKey(4), **kw)),
        "retrieval_params": _np(jdcn.init(jax.random.PRNGKey(5), n_candidates=DCN_CAND, **kw)),
        "batches": [jpipe.recsys_batch(0, s, DCN_B, c.n_dense, c.n_sparse, DCN_VOCAB)
                    for s in range(STEPS)],
        "query": {"dense": q["dense"], "sparse_ids": q["sparse_ids"]},
    }
    return out


def _ref_train(loss, params, batches):
    step = jax.jit(jTS.make_train_step(loss, jadamw.wsd_schedule(**LR), n_micro=N_MICRO))
    st, metrics = jTS.init_state(jax.tree.map(jnp.asarray, params)), []
    for b in batches:
        st, m = step(st, jax.tree.map(jnp.asarray, b))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "state": _np(st)}


def reference(inputs) -> dict:
    """The reference's one-device answers."""
    out = {}
    for arch in LM_ARCHS:
        cfg, x = jreg.get(arch).reduced, inputs[arch]
        p = jax.tree.map(jnp.asarray, x["params"])
        out[arch] = _ref_train(jTS.lm_loss(cfg), x["params"], x["batches"])
        out[arch]["prefill"] = np.asarray(jserve.make_prefill(cfg)(p, jnp.asarray(x["prompt"])))
        out[arch]["tokens"] = np.asarray(jserve.generate(p, cfg, jnp.asarray(x["prompt"]), NEW))
    x = inputs["dcn-v2"]
    out["dcn-v2"] = _ref_train(jTS.dcn_loss(), x["params"], x["batches"])
    b = x["batches"][0]
    out["dcn-v2"]["serve"] = np.asarray(jdcn.serve(jax.tree.map(jnp.asarray, x["params"]),
                                                   jnp.asarray(b["dense"]),
                                                   jnp.asarray(b["sparse_ids"])))
    s, i = jdcn.retrieval(jax.tree.map(jnp.asarray, x["retrieval_params"]),
                          jnp.asarray(x["query"]["dense"]),
                          jnp.asarray(x["query"]["sparse_ids"]), top_k=TOP_K)
    out["dcn-v2"]["retrieval"] = (np.asarray(s), np.asarray(i))
    return out


# ---------------------------------------------------------------------------
# what each rank computes
# ---------------------------------------------------------------------------


def _logical_np(tree) -> dict:
    return {p: t.detach().cpu().numpy().copy() for p, t in flatten_with_paths(tree)}


def _t(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


def _specs(arch, cfg, params, mesh):
    return ttrain.train_specs(registry.get(arch).family, cfg, params, mesh)


def _value(t):
    return (t.full_tensor() if spmd.is_dtensor(t) else t).detach().cpu().numpy()


def lm_case(arch, x, mesh) -> dict:
    """Two train steps, the parameters' global norm, prefill and generate
    (plain and flash decode) on ``mesh`` (None: one rank)."""
    cfg = registry.get(arch).reduced
    params = tL.params_from_numpy(x["params"], device="cpu")
    d = 1 if mesh is None else mesh.size(0)
    specs = None if mesh is None else _specs(arch, cfg, params, mesh)
    step = TS.make_train_step(TS.lm_loss(cfg), adamw.wsd_schedule(**LR),
                              n_micro=N_MICRO // d, mesh=mesh, specs=specs)
    state = TS.init_state(params)
    if mesh is not None:
        state = SH.place(state, specs, mesh)
    metrics, coll = [], []
    for b in x["batches"]:
        with spmd.running() if mesh is not None else contextlib.nullcontext() as mode:
            state, m = step(state, _t(b))
        metrics.append({k: float(v) for k, v in m.items()})
        if mode is not None:
            coll.append(hlo_analysis.collective_bytes(mode.collectives))
    logical = state if mesh is None else SH.gather(state, specs, mesh)
    out = {"metrics": metrics, "state": _logical_np(logical), "coll": coll}
    if mesh is not None:
        out["m_local"] = _logical_np(state.opt.m)
        out["m_want"] = {p: SH.shard_of(t, sp, mesh).numpy().copy() for (p, t), sp in
                         zip(flatten_with_paths(logical.opt.m), leaves(specs.opt.m))}
        served = spmd.distribute(params, specs.params, mesh)
    else:
        served = params
    prompt = torch.from_numpy(x["prompt"])
    with spmd.running() if mesh is not None else contextlib.nullcontext():
        out["norm"] = float(_value(adamw.global_norm(served)))
        out["prefill"] = _value(tserve.make_prefill(cfg)(served, prompt))
    out["tokens"] = tserve.generate(served, cfg, prompt, NEW).numpy()
    out["flash_tokens"] = tserve.generate(served, cfg, prompt, NEW,
                                          use_flash_kernel=True).numpy()
    if mesh is not None:
        cache = tT.init_kv_cache(cfg, PROMPT_B, PROMPT_S + NEW, device="cpu", mesh=mesh)
        out["cache_layout"] = [repr(p) for p in cache["k"].placements]
    return out, (state, specs)


def dcn_case(x, mesh) -> dict:
    cfg = registry.get("dcn-v2").reduced
    params = tL.params_from_numpy(x["params"], device="cpu")
    specs = None if mesh is None else _specs("dcn-v2", cfg, params, mesh)
    d = 1 if mesh is None else mesh.size(0)
    step = TS.make_train_step(TS.dcn_loss(), adamw.wsd_schedule(**LR), n_micro=N_MICRO // d,
                              mesh=mesh, specs=specs)
    state = TS.init_state(params)
    if mesh is not None:
        state = SH.place(state, specs, mesh)
    metrics = []
    for b in x["batches"]:
        state, m = step(state, _t(b))
        metrics.append({k: float(v) for k, v in m.items()})
    logical = state if mesh is None else SH.gather(state, specs, mesh)
    out = {"metrics": metrics, "state": _logical_np(logical)}
    rp = tL.params_from_numpy(x["retrieval_params"], device="cpu")
    b, q = _t(x["batches"][0]), _t(x["query"])
    if mesh is not None:
        out["table_spec"] = SH.spec_to_json(specs.params["embed"]["tables"])
        params = spmd.distribute(params, specs.params, mesh)
        rp = spmd.distribute(rp, SH.dcn_param_specs(rp, mesh), mesh)
    with spmd.running() if mesh is not None else contextlib.nullcontext():
        out["serve"] = _value(tdcn.serve(params, b["dense"], b["sparse_ids"]))
        s, i = tdcn.retrieval(rp, q["dense"], q["sparse_ids"], top_k=TOP_K)
        out["retrieval"] = (_value(s), _value(i))
    return out


def layout_agreement(mesh) -> dict:
    """For every rule's spec on ``mesh``: ``shard_of`` against the local
    shard DTensor lays out for the same placements, ``gather_shard`` /
    ``gather_to_rank0`` of it against the logical tensor, and each tree
    through ``spmd.distribute`` and ``undistribute`` unchanged."""
    from torch.distributed.tensor import distribute_tensor

    g = torch.Generator().manual_seed(3)
    trees = []
    for arch in LM_ARCHS:
        cfg = registry.get(arch).reduced
        p = tT.init_params(g, cfg, dtype=torch.float32, device="cpu")
        ps = SH.spec_tree_like(SH.lm_param_specs(cfg, mesh), p)
        trees += [(p, ps), (p, SH.zero1_specs(ps, p, mesh))]
        for seq in (False, True):
            c = tT.init_kv_cache(cfg, 4, 8, dtype=torch.float32, device="cpu")
            c = {k: torch.randn(v.shape, generator=g).to(v.dtype) for k, v in c.items()}
            trees.append((c, SH.lm_cache_specs(cfg, mesh, seq_shard=seq, batch_size=4)))
    c = registry.get("dcn-v2").reduced
    p = tdcn.init(g, n_dense=c.n_dense, n_sparse=c.n_sparse, embed_dim=c.embed_dim,
                  vocab_per_field=DCN_VOCAB, n_cross=c.n_cross, mlp_dims=c.mlp_dims,
                  device="cpu")
    ps = SH.dcn_param_specs(p, mesh)
    trees += [(p, ps), (p, SH.zero1_specs(ps, p, mesh))]
    checked = both_axes = 0
    for tree, specs in trees:
        back = spmd.undistribute(spmd.distribute(tree, specs, mesh))
        if not all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(tree))):
            return {"ok": False, "round_trip": repr(leaves(specs)[0])}
        for t, sp in zip(leaves(tree), leaves(specs)):
            want = distribute_tensor(t, mesh, SH.placements(mesh, sp)).to_local()
            if not torch.equal(SH.shard_of(t, sp, mesh), want):
                return {"ok": False, "spec": repr(sp), "shape": tuple(t.shape)}
            if not torch.equal(SH.gather_shard(want, sp, mesh), t):
                return {"ok": False, "gather": repr(sp), "shape": tuple(t.shape)}
            r0 = SH.gather_to_rank0(want, sp, mesh)
            if dist.get_rank() == 0 and not torch.equal(r0, t):
                return {"ok": False, "rank0": repr(sp), "shape": tuple(t.shape)}
            names = {n for e in sp for n in SH._names(e)}
            both_axes += {"data", "model"} <= names
            checked += 1
    return {"ok": True, "checked": checked, "both_axes": both_axes}


def masked_set(mesh) -> dict:
    """A set at every row of a target whose rows shard over both mesh
    axes (the decode cache's write on a batch-sharded cache): each rank
    writes its own rows only.  Then a set at two rows of the first
    rank's block, where the other ranks' blocks get no entry."""
    t = torch.arange(24.0).reshape(8, 3)
    rows, few = torch.arange(8), torch.tensor([1, 0])
    vals = -torch.arange(24.0).reshape(8, 3) - 1
    with spmd.running():
        x = spmd.distribute(t.clone(), SH.P(("data", "model"), None), mesh)
        x[rows, torch.tensor(1)] = vals[:, 1]
        x[few, torch.tensor(2)] = vals[few, 2]
        got = x.full_tensor()
    want = t.clone()
    want[rows, 1] = vals[:, 1]
    want[few, 2] = vals[few, 2]
    return {"equal": bool(torch.equal(got, want))}


def _step_dir(root, name):
    return os.path.join(root, name, f"step_{STEPS:09d}")


def _chain(arch, params, mesh, src, dst, root):
    """Restore ``src``'s committed checkpoint onto ``mesh`` by its own
    specs, return the logical leaves, and save them with those specs under
    ``dst``."""
    cfg = registry.get(arch).reduced
    specs = _specs(arch, cfg, params, mesh)
    assert os.path.exists(os.path.join(_step_dir(root, src), "COMMITTED")), src
    step, st = ckpt.restore(os.path.join(root, src), STEPS, device="cpu",
                            template=TS.init_state(params), mesh=mesh, target_specs=specs)
    if dst is not None:
        ckpt.save(os.path.join(root, dst), step, st, specs, mesh=mesh)
    return _logical_np(SH.gather(st, specs, mesh))


def tp_ranks(inputs, root) -> dict:
    """What each rank of the 4- and 2-rank spawns computes."""
    world = dist.get_world_size()
    out = {}
    for shape in MESHES[world]:
        mesh = mesh_lib.rank_mesh(shape, ("data", "model"), device="cpu")
        res = {arch: lm_case(arch, inputs[arch], mesh) for arch in LM_ARCHS}
        if shape == (2, 2):
            state, specs = res["qwen2.5-3b"][1]
            ckpt.save(os.path.join(root, "c22"), STEPS, state, specs, mesh=mesh)
        out[shape] = {arch: r[0] for arch, r in res.items()}
        out[shape]["dcn-v2"] = dcn_case(inputs["dcn-v2"], mesh)
        out[shape]["layout"] = layout_agreement(mesh)
        out[shape]["masked_set"] = masked_set(mesh)
    if world == 4:  # the chain's (4, 1) link, from this spawn's own c22
        out["chain"] = chain_link(inputs, root, (4, 1), "c22", "c41")
    out["host_copied"] = dict(spmd.HOST_COPIED)
    return out


def chain_link(inputs, root, shape, src, dst) -> dict:
    """One link of the checkpoint chain on a ``shape`` mesh."""
    params = tL.params_from_numpy(inputs["qwen2.5-3b"]["params"], device="cpu")
    mesh = mesh_lib.rank_mesh(shape, ("data", "model"), device="cpu")
    return _chain("qwen2.5-3b", params, mesh, src, dst, root)


def one_rank(inputs, root) -> dict:
    """The one-rank answers (a world-size-1 spawn, no mesh)."""
    out = {arch: lm_case(arch, inputs[arch], None)[0] for arch in LM_ARCHS}
    out["dcn-v2"] = dcn_case(inputs["dcn-v2"], None)
    return out


def dry_run_counts() -> dict:
    """The dry run's count of each LM train step the ranks take: the same
    ``make_train_step(mesh=, specs=)`` on meta tensors over a ``fake``
    process group, a cpu mesh of each shape (as the spawns lay theirs)."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor.experimental import implicit_replication

    out = {}
    for shape in ALL_MESHES:
        for arch in LM_ARCHS:
            cfg = registry.get(arch).reduced
            with dryrun.fake_world(shape[0] * shape[1]):
                mesh = DeviceMesh("cpu", torch.arange(shape[0] * shape[1]).reshape(shape),
                                  mesh_dim_names=("data", "model"))
                params = tT.init_params(None, cfg, dtype=torch.float32, device="meta")
                specs = _specs(arch, cfg, params, mesh)
                state = SH.place(TS.init_state(params), specs, mesh)
                step = TS.make_train_step(TS.lm_loss(cfg), adamw.wsd_schedule(**LR),
                                          n_micro=N_MICRO // shape[0], mesh=mesh, specs=specs)
                batch = {k: torch.empty((LM_B, LM_S), dtype=torch.int64, device="meta")
                         for k in ("tokens", "labels")}
                with implicit_replication(), dryrun.CostMode() as cm:
                    step(state, batch)
            out[shape, arch] = hlo_analysis.collective_bytes(cm.collectives)
    return out


def run_spawns(root, inputs, reference_side=lambda: None):
    """The 4-, 2- and 1-rank spawns side by side (with ``reference_side()``
    here meanwhile), then the chain's (1, 1) and (1, 2) links one after
    the other; each spawn's results by name, its seconds, and what
    ``reference_side`` returned."""
    ck = str(root / "ckpt")
    seconds = {}

    def timed(name, fn, world, *args):
        t = time.perf_counter()
        res = spawn_ranks(fn, world, root, inputs, ck, *args, timeout=DEADLINE_S[name],
                          tag=name)
        seconds[name] = time.perf_counter() - t
        return res

    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        jobs = {name: pool.submit(timed, name, fn, w)
                for name, fn, w in (("tp4", tp_ranks, 4), ("tp2", tp_ranks, 2),
                                    ("one", one_rank, 1))}
        side = reference_side()
        res = {name: f.result() for name, f in jobs.items()}
    res["c11"] = timed("c11", chain_link, 1, (1, 1), "c41", "c11")
    res["c12"] = timed("c12", chain_link, 2, (1, 2), "c11", None)
    return res, seconds, side


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    inputs = make_inputs()
    res, seconds, (ref, counted) = run_spawns(
        tmp_path_factory.mktemp("tp"), inputs,
        lambda: (reference(inputs), dry_run_counts()))
    ranks = {4: res["tp4"], 2: res["tp2"]}
    by_mesh = {}
    for w in (4, 2):
        for shape in MESHES[w]:
            by_mesh[shape] = [r[shape] for r in ranks[w]]
    return {"mesh": by_mesh, "ranks": ranks, "one": res["one"][0], "ref": ref,
            "counted": counted, "chain": {"(4, 1)": [r["chain"] for r in res["tp4"]],
                                          "(1, 1)": res["c11"], "(1, 2)": res["c12"]},
            "seconds": seconds}


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------


def _close_leaf(got, want, path, rtol, what):
    """A state leaf: exact for the step counter, else within rtol and atol
    rtol * max|want| (at least ``STEP_ATOL`` for a parameter leaf)."""
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, path)
    if not np.issubdtype(want.dtype, np.floating):
        np.testing.assert_array_equal(got, want, err_msg=f"{what} {path}")
        return
    atol = rtol * max(float(np.abs(want).max()), 1e-30)
    if path.startswith(".params/"):
        atol = max(atol, STEP_ATOL)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=f"{what} {path}")


def _assert_metrics(got, want, rtol, what):
    for s, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "grad_norm", "lr"):
            assert g[k] == pytest.approx(w[k], rel=rtol), f"{what} step {s} {k}"


@pytest.mark.parametrize("mesh", ALL_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_train_matches_one_rank(runs, arch, mesh):
    want = runs["one"][arch]
    for r, res in enumerate(runs["mesh"][mesh]):
        got = res[arch]
        _assert_metrics(got["metrics"], want["metrics"], RTOL_ONE, f"{mesh} rank {r}")
        assert got["state"].keys() == want["state"].keys()
        for p in want["state"]:
            _close_leaf(got["state"][p], want["state"][p], p, RTOL_ONE, f"{mesh} rank {r}")


@pytest.mark.parametrize("mesh", ALL_MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_train_matches_reference(runs, arch, mesh):
    from repro.checkpoint import checkpoint as jckpt

    want = runs["ref"][arch]
    got = runs["mesh"][mesh][0][arch]
    _assert_metrics(got["metrics"], want["metrics"], 1e-5, f"{mesh}")
    jpaths, jleaves, _ = jckpt._flatten_with_paths(want["state"])
    assert list(got["state"]) == jpaths
    for p, j in zip(jpaths, jleaves):
        _close_leaf(got["state"][p], j, p, 1e-4, f"{mesh}")


@pytest.mark.parametrize("mesh", ALL_MESHES)
def test_model_sharded_leaves_and_zero1_moments_are_each_ranks_slices(runs, mesh):
    """Each rank's moments are its ``zero1_specs`` slices: on (2, 2) some
    leaf is sharded over both axes."""
    for r, res in enumerate(runs["mesh"][mesh]):
        for arch in LM_ARCHS:
            got = res[arch]
            assert got["m_local"].keys() == got["m_want"].keys()
            for p in got["m_want"]:
                np.testing.assert_array_equal(got["m_local"][p], got["m_want"][p],
                                              err_msg=f"{mesh} rank {r} {arch} {p}")
            whole = sum(v.size for k, v in got["state"].items() if k.startswith(".opt/.m"))
            local = sum(v.size for v in got["m_local"].values())
            assert local < whole


@pytest.mark.parametrize("mesh", ALL_MESHES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_global_norm_of_sharded_leaves_is_the_one_rank_norm(runs, arch, mesh):
    want = runs["one"][arch]["norm"]
    for res in runs["mesh"][mesh]:
        assert res[arch]["norm"] == pytest.approx(want, rel=RTOL_ONE)


@pytest.mark.parametrize("mesh", ALL_MESHES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_prefill_logits_match_one_rank_and_reference(runs, arch, mesh):
    for want in (runs["one"][arch]["prefill"], runs["ref"][arch]["prefill"]):
        scale = float(np.abs(want).max())
        for res in runs["mesh"][mesh]:
            np.testing.assert_allclose(res[arch]["prefill"], want, rtol=0,
                                       atol=ATOL_OUT * scale)


@pytest.mark.parametrize("mesh", ALL_MESHES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_generate_tokens_match_one_rank_and_reference(runs, arch, mesh):
    want = runs["one"][arch]["tokens"]
    np.testing.assert_array_equal(want, runs["ref"][arch]["tokens"])
    for res in runs["mesh"][mesh]:
        np.testing.assert_array_equal(res[arch]["tokens"], want)


def _layout(res, arch) -> str:
    pl = res[arch]["cache_layout"]  # the k cache (L, B, S, KV, d)'s placements
    return "seq" if "Shard(dim=2)" in pl else "kv" if "Shard(dim=3)" in pl else "none"


def test_both_cache_layouts_are_covered(runs):
    seen = {(mesh, arch): _layout(runs["mesh"][mesh][0], arch)
            for mesh in ALL_MESHES for arch in LM_ARCHS}
    assert seen[(1, 2), "qwen2.5-3b"] == seen[(2, 2), "qwen2.5-3b"] == "kv"
    assert seen[(1, 4), "qwen2.5-3b"] == seen[(1, 2), "smollm-360m"] == "seq"
    # the (2, 2) cache of 4 sequences also shards its batch over the data axis
    assert runs["mesh"][(2, 2)][0]["qwen2.5-3b"]["cache_layout"][0] == "Shard(dim=1)"


@pytest.mark.parametrize("mesh", ALL_MESHES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_flash_decode_on_kv_and_seq_sharded_caches_gives_the_plain_tokens(runs, arch, mesh):
    """The flash path on each rank's kv heads, and on each rank's block of
    a sequence-sharded cache (each launch's log-sum-exp combining the
    ranks' partial outputs), gives the plain decode's tokens."""
    for res in runs["mesh"][mesh]:
        assert _layout(res, arch) in ("kv", "seq")
        np.testing.assert_array_equal(res[arch]["flash_tokens"], res[arch]["tokens"])
    np.testing.assert_array_equal(runs["one"][arch]["flash_tokens"],
                                  runs["one"][arch]["tokens"])


@pytest.mark.parametrize("mesh", ALL_MESHES)
def test_dcn_vocab_sharded_serve_and_retrieval(runs, mesh):
    one, ref = runs["one"]["dcn-v2"], runs["ref"]["dcn-v2"]
    for res in runs["mesh"][mesh]:
        got = res["dcn-v2"]
        assert got["table_spec"] == [None, "model", None]
        for want in (one["serve"], ref["serve"]):
            np.testing.assert_allclose(got["serve"], want, rtol=0, atol=ATOL_OUT)
        for want in (one["retrieval"], ref["retrieval"]):
            np.testing.assert_array_equal(got["retrieval"][1], want[1])
            np.testing.assert_allclose(got["retrieval"][0], want[0], rtol=0,
                                       atol=ATOL_OUT * float(np.abs(want[0]).max()))


@pytest.mark.parametrize("mesh", ALL_MESHES)
def test_shard_slices_agree_with_dtensor_layout(runs, mesh):
    for r, res in enumerate(runs["mesh"][mesh]):
        assert res["layout"]["ok"], (mesh, r, res["layout"])
        assert res["layout"]["checked"] > 40
    if mesh == (2, 2):
        assert runs["mesh"][mesh][0]["layout"]["both_axes"] > 0


@pytest.mark.parametrize("mesh", ALL_MESHES)
def test_masked_set_writes_each_ranks_rows_only(runs, mesh):
    """F4: a set at rows of a target sharded on them writes only the
    rank's own rows (an entry outside, clamped onto the block's edge,
    once met the block's own entry there), also where a rank's block
    gets no entry."""
    for res in runs["mesh"][mesh]:
        assert res["masked_set"]["equal"]


def test_checkpoint_reshards_bit_for_bit(runs):
    """(2, 2) -> (4, 1) -> (1, 1) -> (1, 2): every link's logical leaves
    equal the (2, 2) state's, bit for bit."""
    want = runs["mesh"][(2, 2)][0]["qwen2.5-3b"]["state"]
    links = [(name, got) for name, per_rank in runs["chain"].items() for got in per_rank]
    assert [n for n, _ in links] == ["(4, 1)"] * 4 + ["(1, 1)"] + ["(1, 2)"] * 2
    for name, got in links:
        assert got.keys() == want.keys(), name
        for p in want:
            np.testing.assert_array_equal(got[p], want[p], err_msg=f"{name} {p}")


@pytest.mark.parametrize("mesh", ALL_MESHES)
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_dry_run_counts_the_collectives_the_ranks_move(runs, arch, mesh):
    """Each train step's collectives on the ranks, by kind and in bytes a
    rank, are the dry run's count of the same step (``CostMode`` is the
    ranks' ``SpmdMode`` plus counting)."""
    want = runs["counted"][mesh, arch]
    assert want[0] > 0
    for res in runs["mesh"][mesh]:
        assert res[arch]["coll"] == [want] * STEPS


def test_gloo_on_the_cpu_copies_nothing_through_the_host(runs):
    for w in (4, 2):
        for res in runs["ranks"][w]:
            assert res["host_copied"] == {}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run: python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_attention_decode_under_local_map_matches_plain(cuda, tmp_path):
    """One rank on the card, a (1, 1) mesh: ``attention_decode`` with the
    flash kernel under ``local_map`` on a DTensor cache launches row 12
    and matches the plain decode on plain tensors."""
    from repro_torch.kernels import flash_decode as fd

    cfg = registry.get("qwen2.5-3b").reduced
    mesh_lib.init_ranks("nccl", "cuda", init_method=f"file://{tmp_path}/store", rank=0,
                        world_size=1)
    try:
        mesh = mesh_lib.rank_mesh((1, 1), ("data", "model"), device="cuda")
        g = torch.Generator(device="cuda").manual_seed(0)
        p = tL.attention_init(g, cfg.attn_config, torch.float32, device="cuda")
        x = torch.randn((4, 1, cfg.d_model), generator=g, device="cuda")
        k = torch.randn((4, 64, cfg.n_kv_heads, cfg.head_dim), generator=g, device="cuda")
        v = torch.randn(k.shape, generator=g, device="cuda")
        lens = torch.tensor([0, 5, 31, 63], dtype=torch.int32, device="cuda")
        want, _, _ = tL.attention_decode(p, cfg.attn_config, x, k.clone(), v.clone(), lens)
        ps = SH.replicated_like(p)
        kv = SH.P(None, None, "model", None)
        fd.reset_launches()
        with spmd.running():
            got, _, _ = tL.attention_decode(
                spmd.distribute(p, ps, mesh), cfg.attn_config, x,
                spmd.distribute(k.clone(), kv, mesh), spmd.distribute(v.clone(), kv, mesh),
                lens, use_flash_kernel=True)
            got = got.full_tensor()
        torch.cuda.synchronize()
        assert fd.LAUNCHES["flash_decode"] == 1
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5 * float(want.abs().max()))
    finally:
        dist.destroy_process_group()
