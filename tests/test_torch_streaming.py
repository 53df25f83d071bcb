"""The port's ``AspenStream`` (flat device mirror) against the reference.

Both streams start from the same tree edges and take the same
interleaved insert / delete / weighted batches.  After every publish the
port's mirror must equal a rebuild from its own snapshot and the
reference's mirror, and the port's ``query_batch`` must answer as the
reference's does (BFS parents and integer-weight SSSP bit-identical,
PageRank within atol 1e-6, the reference's reduce in interpret mode).
"""
import threading

import numpy as np
import pytest
import torch

from repro.core import flat_graph as jfg
from repro.core import graph as jG
from repro.core.streaming import AspenStream as JaxStream
from repro.core.streaming import run_concurrent as jax_run_concurrent
from repro_torch.core import flat_graph as tfg
from repro_torch.core import graph as tG
from repro_torch.core import streaming as tst
from repro_torch.core.traversal import ENGINE_BUILDS, TorchEngine, flat_graph_of
from repro_torch.core.traversal import algorithms as talg
from repro_torch.data.rmat import rmat_edges, symmetrize

N = 128


@pytest.fixture(scope="module")
def edges():
    return symmetrize(rmat_edges(7, 900, seed=13))


def _stream(edges, **kw):
    return tst.AspenStream(tG.build_graph(N, edges), device="cpu", **kw)


def _assert_mirror_is_rebuild(s: tst.AspenStream):
    mirror = s.flat_graph()
    rebuilt = flat_graph_of(s.flat_snapshot(), device="cpu")
    assert mirror.n == rebuilt.n
    assert int(mirror.m) == int(rebuilt.m)
    np.testing.assert_array_equal(tfg.to_edge_array(mirror), tfg.to_edge_array(rebuilt))
    np.testing.assert_array_equal(mirror.offsets.numpy(), rebuilt.offsets.numpy())
    if rebuilt.weights is not None:
        np.testing.assert_array_equal(tfg.to_weight_array(mirror), tfg.to_weight_array(rebuilt))


def _assert_same_mirror(s: tst.AspenStream, r: JaxStream):
    t, j = s.flat_graph(), r.flat_graph()
    np.testing.assert_array_equal(tfg.to_edge_array(t), jfg.to_edge_array(j))
    np.testing.assert_array_equal(t.offsets.numpy(), np.asarray(j.offsets))
    assert (t.weights is None) == (j.weights is None)
    if t.weights is not None:
        np.testing.assert_array_equal(tfg.to_weight_array(t), jfg.to_weight_array(j))


def test_interleaved_stream_matches_reference(edges):
    keep, updates = tst.make_update_stream(edges, 240, seed=3)
    s = _stream(keep)
    r = JaxStream(jG.build_graph(N, keep))
    rng = np.random.default_rng(0)
    sources = [0, 3, 3, 17, 64]
    resets = rng.random((2, N))
    resets /= resets.sum(1, keepdims=True)
    for i in range(0, updates.shape[0], 80):
        batch = updates[i:i + 80]
        ins, dels = batch[batch[:, 2] == 0, :2], batch[batch[:, 2] == 1, :2]
        w = rng.integers(1, 5, size=ins.shape[0]).astype(np.float64) if i == 80 else None
        for stream in (s, r):
            stream.insert_edges(ins, weights=w)
            stream.delete_edges(dels)
        _assert_mirror_is_rebuild(s)
        _assert_same_mirror(s, r)
        np.testing.assert_array_equal(s.query_batch(sources, kind="bfs"),
                                      r.query_batch(sources, kind="bfs"))
        np.testing.assert_array_equal(s.query_batch(sources, kind="sssp"),
                                      r.query_batch(sources, kind="sssp"))
        np.testing.assert_array_equal(s.query_batch(sources, kind="distances"),
                                      r.query_batch(sources, kind="distances"))
        np.testing.assert_allclose(s.query_batch(kind="pagerank", resets=resets, iters=3),
                                   r.query_batch(kind="pagerank", resets=resets, iters=3),
                                   rtol=0, atol=1e-6)
    assert s.engine("torch").weighted


def test_vertex_growth_and_vertex_ops(edges):
    s = _stream(edges)
    s.insert_edges(np.array([[N + 5, 2]]))
    assert s.flat_graph().n == N + 6
    _assert_mirror_is_rebuild(s)
    s.delete_vertices(np.array([N + 5]))
    _assert_mirror_is_rebuild(s)


def test_query_batch_torch_matches_numpy_engine(edges):
    s = _stream(edges)
    for kind in ("bfs", "distances", "sssp"):
        np.testing.assert_array_equal(s.query_batch([1, 2, 1], kind=kind),
                                      s.query_batch([1, 2, 1], kind=kind, backend="numpy"))
    np.testing.assert_allclose(s.query_batch([1, 2], kind="bc"),
                               s.query_batch([1, 2], kind="bc", backend="numpy"),
                               rtol=1e-4, atol=1e-4)
    assert s.query_batch([], kind="bfs") == []
    assert s.query_batch(kind="pagerank", resets=np.zeros((0, N))) == []
    out = s.query_multi([{"kind": "bfs", "sources": [4]}, {"kind": "sssp", "sources": []},
                         {"kind": "distances", "sources": [4, 5]}])
    np.testing.assert_array_equal(out[0], s.query_batch([4], kind="bfs"))
    assert out[1] == []
    np.testing.assert_array_equal(out[2], s.query_batch([4, 5], kind="distances"))
    with pytest.raises(ValueError):
        s.query_batch([1], kind="nope")


def test_engine_cache_is_version_pinned(edges):
    s = _stream(edges)
    before = ENGINE_BUILDS.count
    e1 = s.engine("torch")
    assert isinstance(e1, TorchEngine)
    assert s.engine("torch") is e1
    assert ENGINE_BUILDS.count - before == 1
    s.insert_edges(np.array([[1, 100]]))
    assert s.engine("torch") is not e1


def test_versions_are_collected(edges):
    s = _stream(edges)
    held = s.acquire()
    for k in range(5):
        s.insert_edges(np.array([[k, k + 50]]))
    assert s.vg.live_versions() == 2  # the held one and the current one
    assert s.vg.collected_versions() >= 4
    eng = s._engine_for(held, "torch")
    assert eng.m == int(held.aux["flat"].m)
    s.release(held)
    assert s.vg.live_versions() == 1


def test_publish_rebuilds_a_missing_mirror(edges):
    """A version published through the raw ``vg`` writer carries no
    mirror; the next publish rebuilds one from its tree."""
    s = _stream(edges)
    s.vg.update(lambda g: tG.insert_edges(g, np.array([[3, 90], [90, 3]])))
    s.insert_edges(np.array([[4, 91]]))
    _assert_mirror_is_rebuild(s)
    np.testing.assert_array_equal(s.query_batch([3], kind="bfs"),
                                  s.query_batch([3], kind="bfs", backend="numpy"))


def test_update_queue_semantics():
    q = tst.UpdateQueue(maxsize=2)
    assert q.put(1, 2) and q.put(3, 4, delete=True)
    assert not q.put(5, 6, block=False)
    assert not q.put(5, 6, timeout=0.01)
    assert q.pop_batch(1) == [(1, 2, False, None)]
    assert q.put(7, 8, weight=2.5)
    assert len(q) == 2
    stats = q.stats()
    assert stats["rejected"] == 2 and stats["enqueued"] == 3 and stats["high_water"] == 2
    assert q.pop_batch(10) == [(3, 4, True, None), (7, 8, False, 2.5)]
    assert q.pop_batch(10) == []
    assert not q.wait_nonempty(timeout=0.01)


def test_producer_blocked_on_full_queue_wakes_on_drain():
    q = tst.UpdateQueue(maxsize=1)
    q.put(0, 1)
    done = []
    t = threading.Thread(target=lambda: done.append(q.put(2, 3, timeout=5.0)))
    t.start()
    q.pop_batch(1)
    t.join(timeout=5.0)
    assert not t.is_alive() and done == [True]


def test_drain_updates_applies_inserts_then_deletes(edges):
    s = _stream(edges)
    q = tst.UpdateQueue(maxsize=None)
    q.put(5, 99)
    q.put(5, 98, weight=3.0)
    q.put(5, 99, delete=True)
    assert tst.drain_updates(q, s, max_batch=10) == 3
    assert tst.drain_updates(q, s, max_batch=10) == 0
    g = s.flat_graph()
    e = tfg.to_edge_array(g)
    w = tfg.to_weight_array(g)
    have = {(int(a), int(b)): float(x) for (a, b), x in zip(e, w)}
    assert (5, 99) not in have and (99, 5) not in have
    assert have[(5, 98)] == 3.0 and have[(98, 5)] == 3.0
    assert set(np.unique(w[w != 3.0])) == {1.0}  # earlier edges read as unit weight


def test_run_concurrent_serves_torch_engines(edges):
    keep, updates = tst.make_update_stream(edges, 200, seed=1)
    s = _stream(keep)
    stats = tst.run_concurrent(
        s, updates, lambda eng: talg.bfs_multi(eng, [0, 1]), duration_s=0.5,
        batch_size=10, engine_backend="torch", queries_per_call=2,
    )
    assert stats.n_updates > 0 and stats.n_queries > 0
    assert stats.updates_per_sec > 0 and stats.query_latency_isolated_s > 0
    _assert_mirror_is_rebuild(s)


def test_unported_options_and_missing_gpu_raise(edges, monkeypatch):
    """Every mirror option is ported now (the sharded mirror since item 12,
    ``mirror=False`` since the F1 repair); a bad option and a missing GPU
    still raise."""
    from repro_torch.core import sharded_pool as tsp

    sharded = _stream(edges, mirror="sharded", n_shards=2)
    v = sharded.acquire()
    assert isinstance(v.aux[tst.SHARDED_MIRROR], tsp.ShardedGraph) and tst.MIRROR not in v.aux
    sharded.release(v)
    compressed = _stream(edges, compressed=True)
    v = compressed.acquire()
    assert isinstance(v.aux[tst.MIRROR], tfg.CompressedPool)
    compressed.release(v)
    mirrorless = _stream(edges, mirror=False)
    v = mirrorless.acquire()
    assert tst.MIRROR not in v.aux and tst.SHARDED_MIRROR not in v.aux
    mirrorless.release(v)
    with pytest.raises(ValueError):
        _stream(edges, mirror="bogus")
    with pytest.raises(ValueError, match="resident mirror"):
        _stream(edges, mirror=False, compressed=True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        tst.AspenStream(tG.build_graph(N, edges))
    with pytest.raises(RuntimeError, match="no GPU"):
        tfg.from_edges(N, edges)


def test_mirrorless_stream_matches_reference():
    """The F1 repro: ``mirror=False`` serves queries from a per-version
    rebuild, bit-identical to the reference's."""
    e = [[0, 1], [1, 2], [2, 3], [1, 0], [2, 1], [3, 2]]
    got = tst.AspenStream(initial=tG.build_graph(4, e), mirror=False,
                          device="cpu").query_batch([0])
    want = JaxStream(initial=jG.build_graph(4, e), mirror=False).query_batch([0])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [[0, 0, 1, 2]])


def test_mirrorless_stream_falls_back_to_rebuild(edges):
    from repro_torch.core import traversal

    s = _stream(edges, mirror=False)
    base = traversal.FLAT_REBUILDS.count
    eng = s.engine("torch")
    assert traversal.FLAT_REBUILDS.count == base + 1  # the historical path
    assert isinstance(eng, TorchEngine) and eng.device.type == "cpu"
    assert s.engine("torch") is eng  # still version-cached
    src = int(edges[0, 0])
    np.testing.assert_array_equal(talg.bfs_depths(talg.bfs(eng, src), src),
                                  talg.bfs_depths(talg.bfs(s.engine("numpy"), src), src))
    # the publish path, the flat view, a subscription and the default
    # backend all work without a mirror
    with s.subscribe("cc") as sub:
        s.insert_edges(np.array([[0, N - 1]]))
        v = s.acquire()
        assert tst.MIRROR not in v.aux
        s.release(v)
        np.testing.assert_array_equal(sub.refresh(), talg.connected_components(s.engine("torch")))
    _assert_mirror_is_rebuild(s)
    assert s._default_backend() == "torch"
    np.testing.assert_array_equal(s.query_batch([src]), s.query_batch([src], backend="numpy"))


@pytest.mark.parametrize("with_updates", [False, True])
def test_run_concurrent_subscriber_staleness(edges, with_updates):
    """``run_concurrent(subscription=)`` hands ``query_fn`` the live handle
    and samples how many versions the writer is ahead after each call,
    in both packages: with no writer every sample is 0; with one, the mean
    lies between 0 and the number of publishes."""
    keep, updates = tst.make_update_stream(edges, 120, seed=2)
    updates = updates if with_updates else updates[:0]
    out = {}
    for name, stream in (("port", _stream(keep)),
                         ("reference", JaxStream(jG.build_graph(N, keep)))):
        calls = []
        sub = stream.subscribe("cc")
        stamp0 = stream.vg.current_stamp

        def query_fn(handle):
            assert handle is sub
            handle.refresh()
            calls.append(handle.stamp)

        run = tst.run_concurrent if name == "port" else jax_run_concurrent
        res = run(stream, updates, query_fn, duration_s=0.4, batch_size=20, subscription=sub)
        published = stream.vg.current_stamp - stamp0
        assert 0 < res.n_queries <= len(calls)  # one staleness sample per windowed call
        assert 0.0 <= res.subscriber_staleness <= max(published, 0)
        if not with_updates:
            assert published == 0 and res.subscriber_staleness == 0.0
        sub.close()
        out[name] = res
    assert out["port"]._fields == out["reference"]._fields
