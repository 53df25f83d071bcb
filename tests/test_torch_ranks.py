"""The sharded engines and the sharded stream across ``torch.distributed``
ranks, against one rank.

Each world size is one spawn of gloo processes on the CPU, met under a
``FileStore`` in ``tmp_path`` (``launch.mesh.init_ranks``); the ranks
write their answers to files and the checks read them here.  The one-rank
answers come from the same code with no process group, where every
shard row lives in one process and each collective is the local
reduction (that engine is held against the flat engines and the
reference in ``test_torch_sharded_engine.py``).  Counterparts of the
reference's ``multidevice`` tests (``tests/test_sharded_engine.py:429-470``,
``:553``), with the reference's exactness classes: BFS parents and
depths, ``bfs_multi``, CC labels and ``sssp_multi`` on integer weights
bit-identical, PageRank within atol 1e-6 (DESIGN.md §5); the stream's
pool lanes equal after every publish.  The ranks hold 8 shard rows, 4
or 2 each.

``spawn_ranks`` is shared with ``test_torch_moe.py``'s shard_map MoE.
"""
import faulthandler
import os
import pickle
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.core import flat_graph as tfg
from repro_torch.core import graph as tG
from repro_torch.core import sharded_pool as tsp
from repro_torch.core import streaming as tst
from repro_torch.core.traversal import NumpyEngine, make_engine, sharded_graph_of_flat
from repro_torch.core.traversal import algorithms as talg
from repro_torch.core.traversal import sharded_backend as sb
from repro_torch.core.traversal.algorithms import _bfs_relax, _bfs_unvisited
from repro_torch.data.rmat import rmat_edges, symmetrize
from repro_torch.launch import mesh as mesh_lib

N = 256
S = 8
SOURCES = np.random.default_rng(3).integers(0, N, 16)
SPAWN_TIMEOUT_S = 300


# ---------------------------------------------------------------------------
# spawning ranks
# ---------------------------------------------------------------------------


def _run(rank, fn, world, store, out, args):
    faulthandler.enable()  # a rank killed by a signal prints its Python stack
    torch.set_num_threads(1)
    mesh_lib.init_ranks(device="cpu", init_method=f"file://{store}", rank=rank,
                        world_size=world)
    try:
        res = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def spawn_ranks(fn, world: int, tmp_path, *args, timeout: float = SPAWN_TIMEOUT_S,
                tag: str = "") -> list:
    """``fn(*args)`` on ``world`` gloo ranks on the CPU; each rank's
    result, by rank.  Fails the test (and kills the ranks) past
    ``timeout`` seconds.  ``tag`` tells apart two spawns of one world
    size in one ``tmp_path``."""
    out = tmp_path / f"ranks{world}{tag}"
    out.mkdir()
    store = tmp_path / f"store{world}{tag}"
    ctx = mp.spawn(_run, args=(fn, world, str(store), str(out), args), nprocs=world,
                   join=False)
    deadline = time.time() + timeout
    while not ctx.join(timeout=2):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in {timeout} s")
    res = []
    for r in range(world):
        with open(out / f"{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    return res


# ---------------------------------------------------------------------------
# what each rank computes (and one rank computes here)
# ---------------------------------------------------------------------------


def _weights_for(edges):
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    return ((lo * 1000003 + hi) % 7 + 1).astype(np.float64)  # symmetric, integer


def _answers(eng, engw) -> dict:
    parents, depths = eng.bfs_batch(SOURCES)
    return {
        "m": eng.m,
        "bfs_parents": parents.cpu().numpy(),
        "bfs_depths": depths.cpu().numpy(),
        "bfs": talg.bfs(eng, int(SOURCES[0])),
        "bfs_multi": talg.bfs_multi(eng, SOURCES),
        "cc": talg.connected_components(eng),
        "sssp_multi": np.asarray(talg.sssp_multi(engw, SOURCES)),
        "sssp": talg.sssp(engw, int(SOURCES[1])),
        "pagerank": np.asarray(talg.pagerank(eng, iters=10)),
        "wdeg": engw.weighted_degrees.cpu().numpy(),
    }


def graph_answers() -> dict:
    """Raw and compressed sharded engines over 8 shard rows of one rMAT
    graph (this rank's rows under a process group), plus the operand
    sizes of an edgeMap step's collectives."""
    e = symmetrize(rmat_edges(8, 2000, seed=11))
    g = tfg.from_edges(N, e, device="cpu")
    gw = tfg.from_edges(N, e, weights=_weights_for(e), device="cpu")
    sg, sgw = sharded_graph_of_flat(g, S), sharded_graph_of_flat(gw, S)
    mesh = tsp.pool_mesh(S, "cpu")
    out = {
        "rows": sg.pool.rows,
        "raw": _answers(make_engine(sg), make_engine(sgw)),
        "compressed": _answers(make_engine(tsp.compress_sharded(sg, mesh=mesh)),
                               make_engine(tsp.compress_sharded(sgw, mesh=mesh))),
    }
    eng = make_engine(sgw)
    U = eng.frontier_from_ids([0])
    state = torch.full((N,), -1, dtype=torch.int64)
    state[0] = 0
    with sb.collective_log() as log:
        for mode in ("auto", "dense", "sparse"):
            eng.edge_map(U, _bfs_relax, _bfs_unvisited, state, mode=mode)
        eng.bfs_batch(SOURCES[:4])
        eng.edge_map_reduce_batch(torch.ones((4, N)))
    out["log"] = list(log)
    out["local_pool_bytes"] = sgw.pool.data.numel() * 8
    out["host_copied"] = sorted(sb.HOST_COPIED)
    return out


def _lanes(s) -> dict:
    """The stream's pool lanes, all S rows gathered onto this rank, and
    two query kinds served from its engine."""
    p = tsp.gather_pool(s.sharded_graph().pool, tsp.pool_mesh(S, "cpu"))
    return {"keys": tsp.to_array(p), "vals": tsp.to_val_array(p), "n": p.n.numpy(),
            "lo": p.lo.numpy(), "cap": p.cap_per,
            "bfs": np.asarray(s.query_batch(SOURCES[:4], kind="bfs")),
            "sssp": np.asarray(s.query_batch(SOURCES[:4], kind="sssp"))}


def stream_trace(compressed: bool = False) -> dict:
    """``_parity_stream_scenario``'s shape: interleaved insert and delete
    batches, a mid-stream weight upgrade and a bulk insert that grows the
    rows' capacity (the rebalance), with the lanes after every publish,
    and the final answers beside ``NumpyEngine``'s."""
    e = symmetrize(rmat_edges(8, 1500, seed=3))
    keep, updates = tst.make_update_stream(e, 600, seed=4)
    s = tst.AspenStream(tG.build_graph(N, keep), mirror="sharded", n_shards=S,
                        compressed=compressed, device="cpu")
    trace = [_lanes(s)]
    for i in range(0, 600, 150):
        b = updates[i: i + 150]
        ins, dels = b[b[:, 2] == 0][:, :2], b[b[:, 2] == 1][:, :2]
        if ins.size:
            s.insert_edges(ins)
            trace.append(_lanes(s))
        if dels.size:
            s.delete_edges(dels)
            trace.append(_lanes(s))
    if not compressed:
        s.insert_edges(e[:64], weights=_weights_for(e[:64]))  # mid-stream upgrade
        trace.append(_lanes(s))
    s.insert_edges(symmetrize(rmat_edges(8, 2500, seed=9)))  # grows capacity
    trace.append(_lanes(s))
    eng, eng_np = s.engine("sharded"), NumpyEngine(s.flat_snapshot())
    src = int(e[0, 0])
    return {"trace": trace, "rebalances": s.rebalances, "rows": s.sharded_graph().pool.rows,
            "bfs": (talg.bfs(eng, src), talg.bfs(eng_np, src)),
            "cc": (talg.connected_components(eng), talg.connected_components(eng_np))}


def moe_shardmap_run(shape, params_np, x_np, cfg_kw) -> dict:
    """``moe_apply_shardmap`` on a ("data", "model") gloo mesh of
    ``shape``: this rank's data shard of ``x_np`` in, its shard out, and
    the same through the transformer's ``moe_impl="shardmap"`` route."""
    from repro_torch.models import layers as tL
    from repro_torch.models import moe_shardmap as MS
    from repro_torch.models import transformer as tT

    mesh = mesh_lib.rank_mesh(tuple(shape), ("data", "model"), device="cpu")
    common, fields = cfg_kw
    cfg = tT.LMConfig(**common, moe=tT.MoEFields(**fields), moe_impl="shardmap")
    params = tL.params_from_numpy(params_np, device="cpu")
    nd = shape[0]
    di = mesh.get_coordinate()[0]
    b = x_np.shape[0] // nd
    x = torch.from_numpy(x_np[di * b:(di + 1) * b])
    out = MS.moe_apply_shardmap(params, cfg, x, mesh)
    MS.ACTIVE_MESH = mesh
    via_layer = tT._mlp(cfg, params, x)
    return {"rows": (di * b, (di + 1) * b), "out": out.numpy(), "via_layer": via_layer.numpy()}


def rank_run() -> dict:
    return {"graph": graph_answers(), "stream": stream_trace(),
            "stream_compressed": stream_trace(compressed=True)}


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

WORLDS = [2, 4]


@pytest.fixture(scope="module")
def one_rank():
    assert not dist.is_initialized()
    return rank_run()


@pytest.fixture(scope="module", params=WORLDS, ids=[f"k{k}" for k in WORLDS])
def ranks(request, tmp_path_factory):
    k = request.param
    return k, spawn_ranks(rank_run, k, tmp_path_factory.mktemp(f"ranks{k}"))


def _assert_answers_equal(got, want, what):
    assert got["m"] == want["m"], what
    for key in ("bfs_parents", "bfs_depths", "bfs", "cc", "sssp", "sssp_multi"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=f"{what} {key}")
    for a, b in zip(got["bfs_multi"], want["bfs_multi"]):
        np.testing.assert_array_equal(a, b, err_msg=f"{what} bfs_multi")
    np.testing.assert_allclose(got["pagerank"], want["pagerank"], rtol=0, atol=1e-6,
                               err_msg=f"{what} pagerank")
    np.testing.assert_allclose(got["wdeg"], want["wdeg"], rtol=0, atol=1e-5,
                               err_msg=f"{what} weighted degrees")


@pytest.mark.parametrize("layout", ["raw", "compressed"])
def test_sharded_engines_match_one_rank(ranks, one_rank, layout):
    """Every rank holds S/k rows and gives the one-rank engine's answers:
    bit-identical traversals, PageRank within atol 1e-6."""
    k, res = ranks
    for r, out in enumerate(res):
        assert out["graph"]["rows"] == S // k
        _assert_answers_equal(out["graph"][layout], one_rank["graph"][layout],
                              f"k={k} rank {r} {layout}")


def test_collectives_stay_vertex_sized(ranks):
    """Each collective operand a rank sends is vertex- or frontier-sized,
    never its pool rows (the counterpart of
    ``test_edge_map_collectives_vertex_sized``)."""
    k, res = ranks
    for out in res:
        log = out["graph"]["log"]
        names = {name for name, _ in log}
        assert {"pmax", "psum_scatter"} <= names
        biggest = max(b for _, b in log)
        assert biggest <= 8 * 4 * N, f"collective moves {biggest} B: not vertex-sized"
        assert biggest < out["graph"]["local_pool_bytes"]


@pytest.mark.parametrize("kind", ["stream", "stream_compressed"])
def test_sharded_stream_matches_one_rank_every_publish(ranks, one_rank, kind):
    """The sharded stream's lanes, gathered from every rank, equal one
    rank's after each publish (keys, values, counts, boundaries, row
    capacity, through the forced rebalance), its served answers are the
    same, and its final answers agree with ``NumpyEngine``'s."""
    k, res = ranks
    want = one_rank[kind]
    assert want["rebalances"] >= 1
    for r, out in enumerate(res):
        got = out[kind]
        assert got["rebalances"] == want["rebalances"]
        assert got["rows"] == S // k
        assert len(got["trace"]) == len(want["trace"])
        for i, (a, b) in enumerate(zip(got["trace"], want["trace"])):
            what = f"k={k} rank {r} publish {i}"
            for key in ("keys", "n", "lo", "bfs", "sssp"):
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{what} {key}")
            assert a["cap"] == b["cap"], what
            assert (a["vals"] is None) == (b["vals"] is None), what
            if a["vals"] is not None:
                np.testing.assert_array_equal(a["vals"], b["vals"], err_msg=f"{what} vals")
        for key in ("bfs", "cc"):
            np.testing.assert_array_equal(*got[key], err_msg=f"{what} {key} vs numpy")


def test_ranks_see_the_same_answers(ranks):
    """Every rank of a run holds the same replicated answers."""
    _, res = ranks
    for out in res[1:]:
        for layout in ("raw", "compressed"):
            _assert_answers_equal(out["graph"][layout], res[0]["graph"][layout], layout)


def test_init_ranks_refuses_cuda_without_a_gpu():
    """A CUDA request without a GPU raises, as ``_device.resolve`` does,
    before any rendezvous; a mesh needs a process group."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            mesh_lib.init_ranks(device="cuda", init_method="file:///nonexistent", rank=0,
                                world_size=1)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_ranks"):
        mesh_lib.rank_mesh(device="cpu")
