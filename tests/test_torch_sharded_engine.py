"""The port's sharded engines and sharded stream against the flat engines.

The reference's sharded engine does not run under JAX 0.9 (its
``shard_map`` calls pass ``check_rep``; ROADMAP.md §3), so the
port's ``ShardedEngine`` is held against the flat engines on the same
edges, as DESIGN.md §9 defines a sharded result: the port's
``TorchEngine`` and the reference's ``JaxEngine`` (its Pallas reduce in
interpret mode, so its PageRank runs 5 iterations).  Bit-identical: BFS
parents and depths, CC labels, SSSP on integer weights; within atol 1e-6
(DESIGN.md §5): PageRank; within the port's float32 tolerance: BC and
the weighted reduces.  ``CompressedShardedEngine`` is held against the
raw sharded engine (``tests/test_compressed.py:213-245``).  Counterparts
of ``tests/test_sharded_engine.py``: the parity suite for n_shards in
{1, 2, 4, 8}, the collective sizes (``ShardedOps``' log), the mesh
guard, the sharded stream (``AspenStream(mirror="sharded")``), the
version-pinned engine cache, ``query_batch`` routing, ``make_engine``
dispatch and the incremental queries.  On the CPU the kernels' plain
versions run; ``cuda`` tests run the hand kernels on the card.
"""
import numpy as np
import pytest
import torch

from repro.core import flat_graph as jfg
from repro.core.traversal import algorithms as jalg
from repro.core.traversal import make_engine as j_make_engine
from repro_torch.core import compressed as cz
from repro_torch.core import flat_graph as tfg
from repro_torch.core import graph as tG
from repro_torch.core import sharded_pool as tsp
from repro_torch.core import streaming as tst
from repro_torch.core.traversal import (HOST_SYNCS, CompressedShardedEngine, NumpyEngine,
                                        ShardedEngine, TorchEngine, make_engine,
                                        sharded_graph_of_flat)
from repro_torch.core.traversal import algorithms as talg
from repro_torch.core.traversal import sharded_backend as sb
from repro_torch.core.traversal.algorithms import _bfs_relax, _bfs_unvisited
from repro_torch.data.rmat import rmat_edges, symmetrize

N = 256
SHARDS = [1, 2, 4, 8]
SOURCES = np.random.default_rng(3).integers(0, N, 16)


def _weights_for(edges):
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    return ((lo * 1000003 + hi) % 7 + 1).astype(np.float64)  # symmetric, integer


@pytest.fixture(scope="module")
def edges():
    return symmetrize(rmat_edges(8, 2000, seed=11))


@pytest.fixture(scope="module")
def flat(edges):
    """The port's flat engines (plain, weighted) and the reference's."""
    w = _weights_for(edges)
    g, gw = tfg.from_edges(N, edges, device="cpu"), tfg.from_edges(N, edges, weights=w,
                                                                   device="cpu")
    return {"plain": TorchEngine(g), "weighted": TorchEngine(gw),
            "ref": j_make_engine(jfg.from_edges(N, edges)),
            "ref_w": j_make_engine(jfg.from_edges(N, edges, weights=w))}


@pytest.fixture(scope="module")
def ref_answers(flat):
    """The reference flat engine's answers, computed once."""
    je, jw = flat["ref"], flat["ref_w"]
    return {
        "bfs_multi": jalg.bfs_multi(je, SOURCES),
        "cc": np.asarray(jalg.connected_components(je)),
        "sssp_multi": np.asarray(jalg.sssp_multi(jw, SOURCES)),
        "pagerank": np.asarray(jalg.pagerank(je, iters=5)),
    }


_SHARDED = {}


def sharded(flat, S, weighted=False):
    key = (S, weighted)
    if key not in _SHARDED:
        _SHARDED[key] = make_engine(
            sharded_graph_of_flat(flat["weighted" if weighted else "plain"].g, S))
    return _SHARDED[key]


# ---------------------------------------------------------------------------
# (1) the parity suite against the flat engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", SHARDS)
def test_bfs_parity(flat, ref_answers, edges, S):
    eng = sharded(flat, S)
    assert isinstance(eng, ShardedEngine) and eng.n_shards == S
    src = int(edges[0, 0])
    np.testing.assert_array_equal(talg.bfs(eng, src), talg.bfs(flat["plain"], src))
    p, d = talg.bfs_multi(eng, SOURCES)
    pf, df = talg.bfs_multi(flat["plain"], SOURCES)
    np.testing.assert_array_equal(p, pf)
    np.testing.assert_array_equal(d, df)
    np.testing.assert_array_equal(p, ref_answers["bfs_multi"][0])
    np.testing.assert_array_equal(d, ref_answers["bfs_multi"][1])


@pytest.mark.parametrize("S", SHARDS)
def test_cc_parity(flat, ref_answers, S):
    got = talg.connected_components(sharded(flat, S))
    np.testing.assert_array_equal(got, talg.connected_components(flat["plain"]))
    np.testing.assert_array_equal(got, ref_answers["cc"])


@pytest.mark.parametrize("S", SHARDS)
def test_sssp_parity_exact(flat, ref_answers, edges, S):
    """Integer weights: every path sum is computed identically and min is
    order-insensitive, so distances match exactly."""
    eng = sharded(flat, S, weighted=True)
    src = int(edges[0, 0])
    np.testing.assert_array_equal(talg.sssp(eng, src), talg.sssp(flat["weighted"], src))
    got = talg.sssp_multi(eng, SOURCES)
    np.testing.assert_array_equal(got, talg.sssp_multi(flat["weighted"], SOURCES))
    np.testing.assert_array_equal(got, ref_answers["sssp_multi"])


def test_sssp_unweighted_hop_distances(flat):
    np.testing.assert_array_equal(talg.sssp_multi(sharded(flat, 4), SOURCES[:4]),
                                  talg.sssp_multi(flat["plain"], SOURCES[:4]))


@pytest.mark.parametrize("S", SHARDS)
def test_pagerank_parity(flat, ref_answers, S):
    eng = sharded(flat, S)
    pr = talg.pagerank(eng, iters=5)
    np.testing.assert_allclose(pr, talg.pagerank(flat["plain"], iters=5), rtol=0, atol=1e-6)
    np.testing.assert_allclose(pr, ref_answers["pagerank"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(talg.pagerank_multi(eng, iters=5),
                               talg.pagerank_multi(flat["plain"], iters=5), rtol=0, atol=1e-6)
    np.testing.assert_allclose(talg.weighted_pagerank(sharded(flat, S, weighted=True), iters=5),
                               talg.weighted_pagerank(flat["weighted"], iters=5),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("S", [2, 8])
def test_bc_parity(flat, edges, S):
    """BC through ``bc_batch`` and through generic edge_map rounds: float32
    sums in another order, so rtol 1e-4."""
    eng = sharded(flat, S)
    got = talg.bc_multi(eng, SOURCES[:6])
    np.testing.assert_allclose(got, talg.bc_multi(flat["plain"], SOURCES[:6]), rtol=1e-4,
                               atol=1e-4)
    src = int(edges[0, 0])
    np.testing.assert_allclose(talg.bc(eng, src), talg.bc(flat["plain"], src), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("S", [4, 8])
def test_edge_map_reduce_parity(flat, S):
    eng = sharded(flat, S, weighted=True)
    vals = torch.from_numpy(np.random.default_rng(0).standard_normal((4, N)).astype(np.float32))
    want = flat["weighted"].edge_map_reduce_batch(vals)
    torch.testing.assert_close(eng.edge_map_reduce_batch(vals), want, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(eng.edge_map_reduce(vals[0]), want[0], rtol=1e-5, atol=1e-5)


def test_weighted_degrees_parity(flat):
    eng = sharded(flat, 4, weighted=True)
    torch.testing.assert_close(eng.weighted_degrees, flat["weighted"].weighted_degrees)
    np.testing.assert_array_equal(eng.degrees.numpy(), flat["weighted"].degrees.numpy())
    assert int(eng.degrees.sum()) == eng.m == flat["weighted"].m


@pytest.mark.parametrize("frontier", ["small", "large"])
def test_modes_agree(flat, edges, frontier):
    """Forced dense == forced sparse == auto on the sharded engine."""
    eng = sharded(flat, 4)
    ids = [int(edges[0, 0])] if frontier == "small" else list(range(0, N, 2))
    outs = {}
    for mode in ("dense", "sparse", "auto"):
        parents = torch.full((N,), -1, dtype=torch.int64)
        parents[ids] = torch.as_tensor(ids)
        U2, p2 = eng.edge_map(eng.frontier_from_ids(ids), _bfs_relax, _bfs_unvisited, parents,
                              mode=mode)
        outs[mode] = (U2.to_dense().numpy(), p2.numpy())
    for mode in ("sparse", "auto"):
        np.testing.assert_array_equal(outs["dense"][0], outs[mode][0])
        np.testing.assert_array_equal(outs["dense"][1], outs[mode][1])


def test_bfs_batch_one_sync_per_round(flat):
    """The port's contract: one host sync per round, as the flat engine."""
    counts = []
    for eng in (flat["plain"], sharded(flat, 4)):
        base = HOST_SYNCS.count
        talg.bfs_multi(eng, SOURCES)
        counts.append(HOST_SYNCS.count - base)
    assert counts[0] == counts[1]


# ---------------------------------------------------------------------------
# (2) collective sizes: O(frontier + batch), never O(pool)
# ---------------------------------------------------------------------------


def test_edge_map_collectives_vertex_sized(flat):
    eng = sharded(flat, 4, weighted=True)
    U = eng.frontier_from_ids([0])
    state = torch.full((N,), -1, dtype=torch.int64)
    state[0] = 0
    with sb.collective_log() as log:
        for mode in ("auto", "dense", "sparse"):
            eng.edge_map(U, _bfs_relax, _bfs_unvisited, state, mode=mode)
    assert log, "expected cross-shard merges in the edgeMap step"
    pool_bytes = eng.sg.pool.data.numel() * 8
    biggest = max(b for _, b in log)
    assert biggest <= 4 * N * 8, f"collective moves {biggest} B: not vertex-sized"
    assert biggest * 4 <= pool_bytes


def test_bfs_batch_collectives_vertex_sized(flat):
    eng = sharded(flat, 4)
    B = 8
    with sb.collective_log() as log:
        eng.bfs_batch(np.zeros(B, np.int64))
        eng.edge_map_reduce_batch(torch.ones((B, N)))
    assert {name for name, _ in log} >= {"pmax", "psum_scatter"}
    biggest = max(b for _, b in log)
    assert biggest <= 8 * B * N, f"collective moves {biggest} B: not frontier-sized"
    assert biggest < eng.sg.pool.data.numel() * 8


def test_mesh_divisibility_guard(flat):
    sg = sharded_graph_of_flat(flat["plain"].g, 3)
    with pytest.raises(ValueError, match="multiple of the mesh"):
        ShardedEngine(sg, mesh=tsp.PoolMesh(torch.device("cpu"), 2))
    assert ShardedEngine(sg).mesh.shape["shard"] == 1  # one rank divides everything


# ---------------------------------------------------------------------------
# (3) the compressed sharded engine against the raw one
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["adaptive", "fixed2"])
def test_compressed_sharded_parity(flat, edges, layout):
    kw = {} if layout == "adaptive" else {"width": 2}
    for weighted in (False, True):
        raw = sharded(flat, 4, weighted)
        comp = make_engine(tsp.compress_sharded(raw.sg, **kw))
        assert isinstance(comp, CompressedShardedEngine)
        src = int(edges[0, 0])
        np.testing.assert_array_equal(talg.bfs(comp, src), talg.bfs(raw, src))
        for a, b in zip(talg.bfs_multi(comp, SOURCES), talg.bfs_multi(raw, SOURCES)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(talg.connected_components(comp),
                                      talg.connected_components(raw))
        np.testing.assert_array_equal(talg.sssp_multi(comp, SOURCES),
                                      talg.sssp_multi(raw, SOURCES))
        np.testing.assert_allclose(talg.pagerank(comp, iters=5), talg.pagerank(raw, iters=5),
                                   rtol=0, atol=1e-6)
        vals = torch.rand((4, N), generator=torch.Generator().manual_seed(5))
        torch.testing.assert_close(comp.edge_map_reduce_batch(vals),
                                   raw.edge_map_reduce_batch(vals), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(talg.bc_multi(comp, SOURCES[:6]),
                                   talg.bc_multi(raw, SOURCES[:6]), rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(comp.weighted_degrees, raw.weighted_degrees)
        np.testing.assert_array_equal(comp.degrees.numpy(), raw.degrees.numpy())
        assert comp.m == raw.m and comp.n == raw.n
        # the reference's raw engine holds the pool and the full-width aux
        full = cz.pytree_nbytes(raw.sg.pool) + cz.pytree_nbytes(tsp.shard_aux(raw.sg.pool, N))
        assert full / comp.resident_nbytes >= 2.0
        assert comp.resident_nbytes < raw.resident_nbytes <= full


def test_spilled_compressed_sharded_is_rejected():
    """Nine gaps past the int16 limit in one chunk: the checked build
    raises, and an engine over a force-built spilled pool raises."""
    dsts = np.arange(10, dtype=np.int64) * 32_768
    e = np.stack([np.zeros_like(dsts), dsts], axis=1)
    sg = tsp.graph_from_edges(int(dsts.max()) + 1, e, n_shards=1, device="cpu")
    with pytest.raises(ValueError, match="escape"):
        tsp.compress_sharded(sg, width=2)
    cp = tsp.compress_pool(sg.pool, sg.n, 2, 8)
    assert bool(cp.dst.spill.any())
    with pytest.raises(ValueError, match="spill"):
        make_engine(tsp.CompressedShardedGraph(cp, sg.n))


# ---------------------------------------------------------------------------
# (3b) rMAT 2^11 on 8 shard rows: every row spans tens of chunks
# ---------------------------------------------------------------------------

N_BIG, S_BIG = 2048, 8
SOURCES_BIG = np.random.default_rng(4).integers(0, N_BIG, 16)


@pytest.fixture(scope="module")
def big():
    """rMAT 2^11 (~20 K directed edges): the port's and the reference's
    flat engines and the 8-row sharded engines, plain and weighted."""
    edges = symmetrize(rmat_edges(11, 12_000, seed=17))
    w = _weights_for(edges)
    g = tfg.from_edges(N_BIG, edges, device="cpu")
    gw = tfg.from_edges(N_BIG, edges, weights=w, device="cpu")
    out = {"flat": TorchEngine(g), "flat_w": TorchEngine(gw),
           "ref": j_make_engine(jfg.from_edges(N_BIG, edges)),
           "ref_w": j_make_engine(jfg.from_edges(N_BIG, edges, weights=w)),
           "sharded": make_engine(sharded_graph_of_flat(g, S_BIG)),
           "sharded_w": make_engine(sharded_graph_of_flat(gw, S_BIG))}
    assert int(out["sharded"].sg.pool.n.min()) > 4 * cz.CHUNK  # several chunks a row
    return out


@pytest.mark.parametrize("query", ["bfs", "cc", "sssp", "pagerank", "bc", "reduce"])
def test_parity_rmat_2_11_eight_shards(big, query):
    """The parity suite at rMAT 2^11 on 8 shard rows: BFS, CC and integer
    SSSP bit-identical to the port's and the reference's flat engines,
    PageRank within atol 1e-6, BC and the weighted reduce within the
    port's float32 tolerance."""
    eng, eng_w, flat, flat_w = big["sharded"], big["sharded_w"], big["flat"], big["flat_w"]
    if query == "bfs":
        got = talg.bfs_multi(eng, SOURCES_BIG)
        for a, b, c in zip(got, talg.bfs_multi(flat, SOURCES_BIG),
                           jalg.bfs_multi(big["ref"], SOURCES_BIG)):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    elif query == "cc":
        got = talg.connected_components(eng)
        np.testing.assert_array_equal(got, talg.connected_components(flat))
        np.testing.assert_array_equal(got, np.asarray(jalg.connected_components(big["ref"])))
    elif query == "sssp":
        got = talg.sssp_multi(eng_w, SOURCES_BIG)
        np.testing.assert_array_equal(got, talg.sssp_multi(flat_w, SOURCES_BIG))
        np.testing.assert_array_equal(got, np.asarray(jalg.sssp_multi(big["ref_w"], SOURCES_BIG)))
    elif query == "pagerank":
        pr = talg.pagerank(eng, iters=5)
        np.testing.assert_allclose(pr, talg.pagerank(flat, iters=5), rtol=0, atol=1e-6)
        np.testing.assert_allclose(pr, np.asarray(jalg.pagerank(big["ref"], iters=5)), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(talg.weighted_pagerank(eng_w, iters=5),
                                   talg.weighted_pagerank(flat_w, iters=5), rtol=0, atol=1e-6)
    elif query == "bc":
        np.testing.assert_allclose(talg.bc_multi(eng, SOURCES_BIG[:6]),
                                   talg.bc_multi(flat, SOURCES_BIG[:6]), rtol=1e-4, atol=1e-4)
    else:
        rng = np.random.default_rng(6)
        vals = torch.from_numpy(rng.standard_normal((4, N_BIG)).astype(np.float32))
        torch.testing.assert_close(eng_w.edge_map_reduce_batch(vals),
                                   flat_w.edge_map_reduce_batch(vals), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(eng_w.weighted_degrees, flat_w.weighted_degrees)


@pytest.mark.parametrize("layout", ["adaptive", "fixed2"])
def test_compressed_sharded_parity_rmat_2_11(big, layout):
    """The compressed sharded engine against the raw one at rMAT 2^11 on 8
    shard rows (rows of tens of chunks; the adaptive dst lane's hi planes
    hold wide chunks in every row), and its pool decompresses to the raw
    lanes."""
    raw = big["sharded_w"]
    csg = tsp.compress_sharded(raw.sg, **({} if layout == "adaptive" else {"width": 2}))
    if layout == "adaptive":
        assert int(csg.pool.dst.wide.sum(1).min()) >= 2
    back, cap = tsp.decompress_sharded(csg).pool, raw.sg.pool.cap_per
    np.testing.assert_array_equal(back.data.numpy()[:, :cap], raw.sg.pool.data.numpy())
    np.testing.assert_array_equal(back.vals.numpy()[:, :cap], raw.sg.pool.vals.numpy())
    comp = make_engine(csg)
    for a, b in zip(talg.bfs_multi(comp, SOURCES_BIG), talg.bfs_multi(raw, SOURCES_BIG)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(talg.connected_components(comp),
                                  talg.connected_components(raw))
    np.testing.assert_array_equal(talg.sssp_multi(comp, SOURCES_BIG),
                                  talg.sssp_multi(raw, SOURCES_BIG))
    np.testing.assert_allclose(talg.weighted_pagerank(comp, iters=5),
                               talg.weighted_pagerank(raw, iters=5), rtol=0, atol=1e-6)
    vals = torch.rand((4, N_BIG), generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(comp.edge_map_reduce_batch(vals), raw.edge_map_reduce_batch(vals),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# (4) dispatch, the sharded stream, incremental queries
# ---------------------------------------------------------------------------


def test_make_engine_dispatch(flat, edges):
    sg = sharded_graph_of_flat(flat["plain"].g, 4)
    eng = make_engine(sg)
    assert type(eng) is ShardedEngine
    assert type(make_engine(tsp.compress_sharded(sg))) is CompressedShardedEngine
    with pytest.raises(TypeError):
        make_engine(sg, backend="torch")
    with pytest.raises(TypeError):
        make_engine(tsp.compress_sharded(sg), backend="numpy")
    with pytest.raises(ValueError):
        make_engine(sg, backend="nope")
    assert type(make_engine(flat["plain"].g, backend="sharded")) is ShardedEngine
    eng2 = make_engine(tG.flat_snapshot(tG.build_graph(N, edges)), backend="sharded",
                       device="cpu")
    src = int(edges[0, 0])
    np.testing.assert_array_equal(talg.bfs(eng, src), talg.bfs(eng2, src))


def _parity_stream_scenario(n_shards, compressed=False):
    """Interleaved insert / delete batches, a mid-stream weight upgrade and
    a bulk insert that must grow capacity (the rebalance path), applied
    through ``AspenStream(mirror="sharded")``."""
    e = symmetrize(rmat_edges(8, 1500, seed=3))
    keep, updates = tst.make_update_stream(e, 600, seed=4)
    s = tst.AspenStream(tG.build_graph(N, keep), mirror="sharded", n_shards=n_shards,
                        compressed=compressed, device="cpu")
    for i in range(0, 600, 150):
        b = updates[i: i + 150]
        ins, dels = b[b[:, 2] == 0][:, :2], b[b[:, 2] == 1][:, :2]
        if ins.size:
            s.insert_edges(ins)
        if dels.size:
            s.delete_edges(dels)
    s.insert_edges(e[:64], weights=_weights_for(e[:64]))  # mid-stream upgrade
    s.insert_edges(symmetrize(rmat_edges(8, 2500, seed=9)))  # grows capacity
    return s


@pytest.mark.parametrize("n_shards", [1, 4])
def test_stream_sharded_mirror_parity(n_shards):
    s = _parity_stream_scenario(n_shards)
    assert s.rebalances >= 1
    eng = s.engine("sharded")
    assert isinstance(eng, ShardedEngine) and eng.weighted  # the upgrade stuck
    flat = make_engine(s.flat_graph())
    eng_np = NumpyEngine(s.flat_snapshot())
    assert eng.m == eng_np.m == flat.m
    np.testing.assert_array_equal(tsp.graph_to_edge_array(s.sharded_graph()),
                                  tfg.to_edge_array(s.flat_graph()))
    np.testing.assert_array_equal(tsp.graph_to_weight_array(s.sharded_graph()),
                                  tfg.to_weight_array(s.flat_graph()))
    np.testing.assert_array_equal(talg.bfs(eng_np, 0), talg.bfs(eng, 0))
    np.testing.assert_array_equal(talg.connected_components(eng_np),
                                  talg.connected_components(eng))
    np.testing.assert_array_equal(talg.sssp(flat, 0), talg.sssp(eng, 0))
    np.testing.assert_allclose(talg.pagerank(flat, iters=4), talg.pagerank(eng, iters=4),
                               rtol=0, atol=1e-6)
    stats = s.shard_stats()
    assert stats["n_shards"] == n_shards and stats["imbalance"] >= 1.0


def test_stream_interleaved_parity_sharded():
    """Raw and compressed sharded streams take the same batches: equal
    pools after every publish, and equal answers from their engines."""
    e = symmetrize(rmat_edges(7, 900, seed=13))
    keep, updates = tst.make_update_stream(e, 400, seed=3)
    raw = tst.AspenStream(tG.build_graph(128, keep), mirror="sharded", n_shards=4,
                          device="cpu")
    com = tst.AspenStream(tG.build_graph(128, keep), mirror="sharded", n_shards=4,
                          compressed=True, device="cpu")
    for i in range(0, updates.shape[0], 100):
        b = updates[i: i + 100]
        for s in (raw, com):
            s.insert_edges(b[b[:, 2] == 0][:, :2])
            s.delete_edges(b[b[:, 2] == 1][:, :2])
        a, c = raw.sharded_graph(), com.sharded_graph()
        np.testing.assert_array_equal(tsp.graph_to_edge_array(a), tsp.graph_to_edge_array(c))
        np.testing.assert_array_equal(a.pool.n.numpy(), c.pool.n.numpy())
    er, ec = raw.engine("sharded"), com.engine("sharded")
    assert type(er) is ShardedEngine and type(ec) is CompressedShardedEngine
    src = int(e[0, 0])
    np.testing.assert_array_equal(talg.bfs(er, src), talg.bfs(ec, src))
    np.testing.assert_array_equal(talg.connected_components(er), talg.connected_components(ec))


def test_engine_version_pinned_cache(edges):
    s = tst.AspenStream(tG.build_graph(N, edges[:1000]), mirror="sharded", n_shards=4,
                        device="cpu")
    e1 = s.engine("sharded")
    assert s.engine("sharded") is e1
    s.insert_edges(edges[1000:1010])
    e2 = s.engine("sharded")
    assert e2 is not e1 and e2.m >= e1.m


def test_query_batch_routes_to_sharded_mirror(edges):
    s = tst.AspenStream(tG.build_graph(N, edges), mirror="sharded", n_shards=4, device="cpu")
    assert s._default_backend() == "sharded"
    srcs = np.random.default_rng(2).integers(0, N, 8)
    out = s.query_batch(srcs, kind="bfs")
    v = s.acquire()
    try:
        assert ("engine", "sharded") in v.cache and ("engine", "torch") not in v.cache
        assert tst.MIRROR not in v.aux and tst.SHARDED_MIRROR in v.aux
    finally:
        s.release(v)
    eng_np = NumpyEngine(s.flat_snapshot())
    np.testing.assert_array_equal(out, talg.bfs_multi(eng_np, srcs)[0])
    np.testing.assert_array_equal(s.query_batch(srcs, kind="distances"),
                                  talg.landmark_distances(eng_np, srcs))


def test_sharded_graph_of_other_streams(edges):
    """``sharded_graph()`` on a flat stream partitions its mirror (one
    row: the default shard count); ``shard_stats()`` is None there."""
    s = tst.AspenStream(tG.build_graph(N, edges), device="cpu")
    sg = s.sharded_graph()
    assert sg.n_shards == tsp.default_n_shards()
    np.testing.assert_array_equal(tsp.graph_to_edge_array(sg), tfg.to_edge_array(s.flat_graph()))
    assert s.shard_stats() is None
    assert isinstance(s.engine("sharded"), ShardedEngine)


def test_incremental_parity_sharded():
    """Two held versions one weighted insert and one delete batch apart,
    through the sharded mirror: incremental BFS / SSSP / CC equal a full
    recompute and the numpy engine; warm PageRank reaches the cold fixed
    point."""
    e = symmetrize(rmat_edges(8, 2000, seed=11))
    s = tst.AspenStream(tG.build_graph(N, e, weights=_weights_for(e)), mirror="sharded",
                        n_shards=4, device="cpu")
    v1 = s.vg.acquire()
    rng = np.random.default_rng(13)
    batch = rng.integers(0, N, size=(40, 2)).astype(np.int64)
    batch = batch[batch[:, 0] != batch[:, 1]][:24]
    s.insert_edges(batch, weights=_weights_for(batch))
    vmid = s.vg.acquire()  # held, so the hop's delta record stays live
    s.delete_edges(e[:20], symmetric=False)
    v2 = s.vg.acquire()
    delta = s.vg.delta_between(v1, v2)
    assert delta is not None and delta.has_deletions
    s.vg.release(vmid)
    e1, e2 = s._engine_for(v1, "sharded"), s._engine_for(v2, "sharded")
    e2_np = NumpyEngine(tG.flat_snapshot(v2.graph))
    src = np.array([0, 31, 128], np.int64)
    p1, d1 = talg.bfs_multi(e1, src)
    ip, idp = talg.incremental_bfs(e2, src, p1, d1, delta)
    fp, fd = talg.bfs_multi(e2, src)
    np.testing.assert_array_equal(idp, fd)
    np.testing.assert_array_equal(ip, fp)
    np.testing.assert_array_equal(idp, talg.bfs_multi(e2_np, src)[1])
    dist1 = np.asarray(talg.sssp_multi(e1, src), np.float64)
    tree1 = talg.shortest_path_parents(e1, dist1, src)
    idist = talg.incremental_sssp(e2, src, dist1, tree1, delta)
    np.testing.assert_array_equal(idist, talg.sssp_multi(e2, src))
    np.testing.assert_array_equal(idist, talg.sssp_multi(e2_np, src))
    prev = np.asarray(talg.connected_components(e1), np.int64)
    np.testing.assert_array_equal(talg.incremental_connected_components(e2, prev, delta),
                                  talg.connected_components(e2_np))
    pr_prev = talg.pagerank(e1, tol=1e-6)
    cold = np.asarray(talg.pagerank(e2, tol=1e-6))
    warm = np.asarray(talg.pagerank(e2, tol=1e-6, init=pr_prev))
    assert np.abs(warm - cold).max() <= 2e-6
    with s.subscribe("bfs", sources=src) as sub:
        s.insert_edges(batch[:4] + 1)
        sub.refresh()
        assert sub.n_incremental == 1
        np.testing.assert_array_equal(sub.value[0], s.query_batch(src, kind="bfs"))
    s.vg.release(v1)
    s.vg.release(v2)


# ---------------------------------------------------------------------------
# (5) on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run: python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("compressed", [False, True])
def test_sharded_engine_on_the_card(cuda, flat, edges, compressed):
    """The sharded engines on the card (rows 1-6 and 8-9 launched) give the
    CPU engines' answers: BFS, CC and integer SSSP bit-identical,
    PageRank within atol 1e-6."""
    from repro_torch.kernels import delta_decode as dd
    from repro_torch.kernels import segment_reduce as sr

    sg = tsp.graph_from_edges(N, edges, n_shards=4, weights=_weights_for(edges), device=cuda)
    eng = make_engine(tsp.compress_sharded(sg) if compressed else sg)
    cpu = sharded(flat, 4, weighted=True)
    before = dict(sr.LAUNCHES), dict(dd.LAUNCHES)
    for a, b in zip(talg.bfs_multi(eng, SOURCES), talg.bfs_multi(cpu, SOURCES)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(talg.connected_components(eng), talg.connected_components(cpu))
    np.testing.assert_array_equal(talg.sssp_multi(eng, SOURCES), talg.sssp_multi(cpu, SOURCES))
    np.testing.assert_allclose(talg.weighted_pagerank(eng, iters=5),
                               talg.weighted_pagerank(cpu, iters=5), rtol=0, atol=1e-6)
    launched = sum(sr.LAUNCHES.values()) - sum(before[0].values())
    assert launched > 0
    if compressed:
        assert sum(dd.LAUNCHES.values()) > sum(before[1].values())
