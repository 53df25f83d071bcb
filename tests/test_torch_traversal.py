"""``TorchEngine`` against ``JaxEngine`` and ``NumpyEngine`` on one edge set.

The same symmetric rMAT edges (n = 256) build the reference's FlatGraph,
the port's FlatGraph (from the reference's leaves, ``from_state``) and
the port's host tree.  Bit-identical: BFS parents and depths, CC labels,
SSSP on integer weights, ``parents_from_depths``.  Within atol 1e-6:
PageRank, ``pagerank_multi`` and weighted PageRank (the reference runs
5 iterations, its Pallas reduce in interpret mode).  BC within float32
tolerance (rtol 1e-4): the three engines sum in different orders.
"""
import numpy as np
import pytest
import torch

from repro.core import flat_graph as jfg
from repro.core import graph as jG
from repro.core.traversal import algorithms as jalg
from repro.core.traversal import make_engine as j_make_engine
from repro_torch.core import flat_graph as tfg
from repro_torch.core import graph as tG
from repro_torch.core.traversal import HOST_SYNCS, ShardedEngine, TorchEngine, make_engine
from repro_torch.core.traversal import algorithms as talg
from repro_torch.core.traversal import torch_backend as tb
from repro_torch.data.rmat import rmat_edges, symmetrize

N = 256
SOURCES = [0, 1, 5, 77, 200]


def _engines(weighted: bool):
    edges = symmetrize(rmat_edges(8, 1500, seed=4))
    w = None
    if weighted:  # integer weights in 1..5, symmetric: w(u, v) == w(v, u)
        key = np.minimum(edges[:, 0], edges[:, 1]) * N + np.maximum(edges[:, 0], edges[:, 1])
        w = (key % 5 + 1).astype(np.float64)
    jg = jfg.from_edges(N, edges, weights=w)
    tg = tfg.from_state(np.asarray(jg.offsets), np.asarray(jg.keys), int(jg.m),
                        None if jg.weights is None else np.asarray(jg.weights), device="cpu")
    tree = tG.build_graph(N, edges, weights=w)
    return make_engine(tg), j_make_engine(jg), make_engine(tG.flat_snapshot(tree))


@pytest.fixture(scope="module")
def plain():
    return _engines(weighted=False)


@pytest.fixture(scope="module")
def weighted():
    return _engines(weighted=True)


def test_from_edges_matches_from_state(plain):
    te, je, _ = plain
    edges = jfg.to_edge_array(je.g)
    g2 = tfg.from_edges(N, edges, device="cpu")
    np.testing.assert_array_equal(g2.keys.numpy(), te.g.keys.numpy())
    np.testing.assert_array_equal(g2.offsets.numpy(), te.g.offsets.numpy())


def test_engine_aux_bit_identical(plain):
    te, je, _ = plain
    for name in je.aux._fields:
        want = getattr(je.aux, name)
        got = getattr(te.aux, name)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)


def test_bfs_batch_bit_identical(plain):
    te, je, ne = plain
    tp, td = talg.bfs_multi(te, SOURCES)
    jp, jd = jalg.bfs_multi(je, SOURCES)
    np_, nd = talg.bfs_multi(ne, SOURCES)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tp, np_)
    np.testing.assert_array_equal(td, nd)


@pytest.mark.parametrize("mode", [True, False])
def test_single_source_bfs_bit_identical(plain, mode):
    te, je, ne = plain
    for s in SOURCES[:3]:
        want = jalg.bfs(je, s, direction_optimize=mode)
        np.testing.assert_array_equal(talg.bfs(te, s, direction_optimize=mode), want)
        np.testing.assert_array_equal(talg.bfs(ne, s, direction_optimize=mode), want)


def test_cc_labels_bit_identical(plain):
    te, je, ne = plain
    want = jalg.connected_components(je)
    np.testing.assert_array_equal(talg.connected_components(te), want)
    np.testing.assert_array_equal(te.cc_labels().numpy(), np.asarray(je.cc_labels()))
    np.testing.assert_array_equal(talg.connected_components(ne), want)


def test_parents_from_depths_bit_identical(plain):
    te, je, _ = plain
    _, depths = jalg.bfs_multi(je, SOURCES)
    np.testing.assert_array_equal(talg.parents_from_depths(te, depths),
                                  jalg.parents_from_depths(je, depths))


@pytest.mark.parametrize("direction_optimize", [True, False])
def test_sssp_integer_weights_bit_identical(weighted, direction_optimize):
    te, je, ne = weighted
    want = jalg.sssp_multi(je, SOURCES, direction_optimize=direction_optimize)
    np.testing.assert_array_equal(
        talg.sssp_multi(te, SOURCES, direction_optimize=direction_optimize), want)
    np.testing.assert_array_equal(talg.sssp_multi(ne, SOURCES), want)


def test_sssp_batch_from_matches(weighted):
    te, je, _ = weighted
    d0 = jalg.sssp_multi(je, SOURCES[:2])
    d0[:, ::3] = np.inf
    f0 = np.isfinite(d0)
    for unit in (False, True):
        np.testing.assert_array_equal(talg.warm_distances(te, d0, f0, unit=unit),
                                      jalg.warm_distances(je, d0, f0, unit=unit))


@pytest.mark.parametrize("which", ["plain", "weighted"])
def test_pagerank_within_1e6(plain, weighted, which):
    te, je, ne = plain if which == "plain" else weighted
    want = jalg.pagerank(je, iters=5)
    np.testing.assert_allclose(talg.pagerank(te, iters=5), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(talg.pagerank(ne, iters=5), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(talg.weighted_pagerank(te, iters=5), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("which", ["plain", "weighted"])
def test_pagerank_multi_within_1e6(plain, weighted, which):
    te, je, ne = plain if which == "plain" else weighted
    rng = np.random.default_rng(3)
    resets = rng.random((4, N))
    resets /= resets.sum(1, keepdims=True)
    want = jalg.pagerank_multi(je, resets, iters=5)
    np.testing.assert_allclose(talg.pagerank_multi(te, resets, iters=5), want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(talg.pagerank_multi(ne, resets, iters=5), want, rtol=0, atol=1e-6)


def test_weighted_degrees_match(weighted):
    te, je, ne = weighted
    np.testing.assert_allclose(te.weighted_degrees.numpy(), np.asarray(je.weighted_degrees),
                               rtol=1e-6)
    np.testing.assert_allclose(te.weighted_degrees.numpy(), ne.weighted_degrees, rtol=1e-6)


def test_bc_within_f32_tolerance(plain):
    te, je, ne = plain
    want = jalg.bc_multi(je, SOURCES)
    np.testing.assert_allclose(talg.bc_multi(te, SOURCES), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(talg.bc_multi(ne, SOURCES), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(talg.bc(te, SOURCES[1]), jalg.bc(je, SOURCES[1]),
                               rtol=1e-4, atol=1e-4)


def test_whole_graph_loops_match(plain):
    from repro.core.traversal import jax_backend as jb

    te, je, _ = plain
    np.testing.assert_array_equal(tb.bfs_levels(te.g, 3, te.aux).numpy(),
                                  np.asarray(jb.bfs_levels(je.g, 3, je.aux)))
    f = np.zeros(N, bool)
    f[[0, 9, 40]] = True
    np.testing.assert_array_equal(tb.dense_expand(te.g, torch.from_numpy(f)).numpy(),
                                  np.asarray(jb.dense_expand(je.g, f)))


def test_bfs_batch_host_sync_contract(plain):
    """The port's contract (base.py): one sync per round, D + 2 for a
    traversal whose deepest lane has depth D, whatever the batch size."""
    te, _, _ = plain
    for sources in ([3], SOURCES):
        before = HOST_SYNCS.count
        _, depths = te.bfs_batch(sources)
        assert HOST_SYNCS.count - before == int(depths.max()) + 2


def test_single_source_rounds_sync_once(plain):
    """A serial BFS pays one sync per round: the stop test's size probe
    also carries deg(U) for the Beamer decision."""
    te, _, _ = plain
    before = HOST_SYNCS.count
    parents = talg.bfs(te, 3)
    depths = talg.bfs_depths(parents, 3)
    assert HOST_SYNCS.count - before == int(depths.max()) + 2 + 1  # + to_host


def test_resident_nbytes_counts_pool_and_aux(plain):
    te, _, _ = plain
    cap = te.g.edge_capacity
    assert te.resident_nbytes >= cap * (8 + 4 * 4) + N * 4


def test_make_engine_dispatch(plain):
    te, _, ne = plain
    assert isinstance(make_engine(te.g), TorchEngine)
    assert isinstance(make_engine(ne.snap, backend="torch", device="cpu"), TorchEngine)
    sharded = make_engine(te.g, backend="sharded")  # ported: the sharded engine
    assert isinstance(sharded, ShardedEngine) and sharded.m == te.m
    np.testing.assert_array_equal(talg.bfs(sharded, 3), talg.bfs(te, 3))
    with pytest.raises(ValueError):
        make_engine(te.g, backend="jax")
