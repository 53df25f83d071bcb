"""The port's incremental queries, subscriptions and publish listeners
against the reference (DESIGN.md §11).

Both packages build their streams from the same numpy edges and take
the same batches.  The port runs on the CPU (``device="cpu"``, its
kernels' plain versions); the reference's jax engine runs its Pallas
reduce in interpret mode, as its own tests do.  Held:

  (1) warm-start PageRank reaches the reference's fixed point (atol
      1e-6, DESIGN.md §5) in the same number of rounds, cold and warm;
  (2) ``incremental_connected_components`` / ``_bfs`` / ``_sssp`` are
      bit-identical to a full recompute and to the reference's
      incremental results, on the numpy and the torch engine;
  (3) subscriptions stay fresh through the incremental path (the same
      path counts as the reference's), weighted SSSP included, fall back
      to a full recompute on a broken chain, and guard their close;
  (4) ``on_publish`` listeners fire after the write lock is released,
      unsubscribe, and cannot break the writer;
  (5) the same holds on a ``compressed=True`` stream.
"""
import numpy as np
import pytest
import torch

from repro.core import graph as jG
from repro.core.streaming import AspenStream as JaxStream
from repro.core.traversal import algorithms as jalg
from repro_torch.core import graph as tG
from repro_torch.core import streaming as tst
from repro_torch.core.traversal import CompressedEngine, TorchEngine
from repro_torch.core.traversal import algorithms as talg
from repro_torch.core.versioning import Delta
from repro_torch.data.rmat import rmat_edges, symmetrize

N = 256
PR_ATOL = 1e-6  # float32 PageRank against the reference (DESIGN.md §5)
SOURCES = np.array([0, 31, 128], np.int64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and with
    several test workers on the machine torch's default pool oversubscribes
    the cores (a publish then takes tens of ms instead of one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights_for(edges):
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    return ((lo * 1000003 + hi) % 7 + 1).astype(np.float64)  # symmetric, integer


@pytest.fixture(scope="module")
def base_edges():
    return symmetrize(rmat_edges(8, 2000, seed=7))  # 256 vertices


@pytest.fixture(scope="module")
def batch(base_edges):
    """~1% of directed edges, self-loop-free, deterministic."""
    k = max(1, base_edges.shape[0] // 100)
    rng = np.random.default_rng(3)
    b = rng.integers(0, N, size=(4 * k, 2)).astype(np.int64)
    return b[b[:, 0] != b[:, 1]][:k]


def _port(edges, weights=None, **kw):
    return tst.AspenStream(tG.build_graph(N, edges, weights=weights), device="cpu", **kw)


def _ref(edges, weights=None):
    return JaxStream(jG.build_graph(N, edges, weights=weights))


def _versioned_pair(s, base_edges, batch, weighted=False):
    """Two held versions of ``s`` one insert batch and one delete batch
    apart, the held version between them, and the composed deltas."""
    v1 = s.vg.acquire()
    s.insert_edges(batch, **({"weights": _weights_for(batch)} if weighted else {}))
    vmid = s.vg.acquire()
    s.delete_edges(base_edges[:20], symmetric=False)
    v2 = s.vg.acquire()
    d = s.vg.delta_between(v1, v2)
    assert d is not None and d.has_deletions
    dmid = s.vg.delta_between(v1, vmid)
    assert not dmid.has_deletions
    return v1, vmid, v2, d, dmid


def _incremental_results(s, backend, base_edges, batch, weighted):
    """Every incremental answer of one stream: cc over the insert-only hop
    and over the hop with deletions, bfs over both, sssp over both, each
    beside the full recompute on the same version."""
    v1, vmid, v2, d, dmid = _versioned_pair(s, base_edges, batch, weighted)
    e1, emid, e2 = (s._engine_for(v, backend) for v in (v1, vmid, v2))
    alg = jalg if backend == "jax" else talg
    labels = np.asarray(alg.connected_components(e1), np.int64)
    out = {}
    for tag, eng, delta in (("mid", emid, dmid), ("end", e2, d), ("none", e2, None)):
        out[f"cc_{tag}"] = np.asarray(
            alg.incremental_connected_components(eng, labels, delta), np.int64)
        out[f"cc_{tag}_full"] = np.asarray(alg.connected_components(eng), np.int64)
    p1, d1 = alg.bfs_multi(e1, SOURCES)
    dist1 = np.asarray(alg.sssp_multi(e1, SOURCES), np.float64)
    tree1 = alg.shortest_path_parents(e1, dist1, SOURCES)
    for tag, eng, delta in (("mid", emid, dmid), ("end", e2, d)):
        out[f"bfs_{tag}"] = alg.incremental_bfs(eng, SOURCES, p1, d1, delta)
        out[f"bfs_{tag}_full"] = alg.bfs_multi(eng, SOURCES)
        out[f"sssp_{tag}"] = alg.incremental_sssp(eng, SOURCES, dist1, tree1, delta)
        out[f"sssp_{tag}_full"] = alg.sssp_multi(eng, SOURCES)
    for v in (v1, vmid, v2):
        s.vg.release(v)
    return out


@pytest.fixture(scope="module")
def reference_results(base_edges, batch):
    return {w: _incremental_results(_ref(base_edges, _weights_for(base_edges) if w else None),
                                    "jax", base_edges, batch, w)
            for w in (False, True)}


def _assert_same(a, b):
    if isinstance(a, tuple):
        for x, y in zip(a, b):
            _assert_same(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# (1) warm-start PageRank
# ---------------------------------------------------------------------------


def test_warm_pagerank_matches_reference_rounds_and_fixed_point(base_edges, batch):
    """After a 1% batch, cold and warm PageRank on the torch engine land
    on the reference's fixed point in the reference's round counts, and
    half the cold rounds warm are within the reference's own 2e-6."""
    new = np.concatenate([base_edges, batch, batch[:, ::-1]])
    engines = {"port": (_port(base_edges).engine("torch"), _port(new).engine("torch"), talg),
               "ref": (_ref(base_edges).engine("jax"), _ref(new).engine("jax"), jalg)}
    got = {}
    for who, (eng1, eng2, alg) in engines.items():
        prev = np.asarray(alg.pagerank(eng1, tol=1e-6))
        alg.PAGERANK_ROUNDS.count = 0
        cold = np.asarray(alg.pagerank(eng2, tol=1e-6))
        cold_rounds = alg.PAGERANK_ROUNDS.count
        alg.PAGERANK_ROUNDS.count = 0
        warm = np.asarray(alg.pagerank(eng2, tol=1e-6, init=prev))
        warm_rounds = alg.PAGERANK_ROUNDS.count
        half = np.asarray(alg.pagerank(eng2, iters=cold_rounds // 2, init=prev))
        got[who] = (prev, cold, cold_rounds, warm, warm_rounds, half)
    prev, cold, cold_rounds, warm, warm_rounds, half = got["port"]
    assert cold_rounds >= 4 and warm_rounds < cold_rounds
    assert (cold_rounds, warm_rounds) == (got["ref"][2], got["ref"][4])
    for mine, theirs in zip((prev, cold, warm, half), [got["ref"][i] for i in (0, 1, 3, 5)]):
        np.testing.assert_allclose(mine, theirs, rtol=0, atol=PR_ATOL)
    assert np.abs(half - cold).max() <= 2e-6
    assert np.abs(warm - cold).max() <= PR_ATOL


# ---------------------------------------------------------------------------
# (2) incremental CC / BFS / SSSP: exact, and the reference's bits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_incremental_results_exact_and_equal_to_reference(
        base_edges, batch, reference_results, backend, weighted):
    w = _weights_for(base_edges) if weighted else None
    got = _incremental_results(_port(base_edges, w), backend, base_edges, batch, weighted)
    ref = reference_results[weighted]
    assert set(got) == set(ref)
    for key, val in got.items():
        _assert_same(val, ref[key])  # the reference's incremental and full answers
        if not key.endswith("_full"):
            full = key.replace("_none", "_end") + "_full"
            _assert_same(val, got[full])  # incremental == a full recompute


def test_incremental_handles_vertex_growth(base_edges):
    """A batch that creates vertices past n pads the previous rows; the
    result still equals a full recompute on the grown graph."""
    s = _port(base_edges)
    v1 = s.vg.acquire()
    e1 = s._engine_for(v1, "torch")
    p1, d1 = talg.bfs_multi(e1, SOURCES)
    labels = talg.connected_components(e1)
    s.insert_edges(np.array([[0, N + 3], [N + 3, N + 5]]))
    v2 = s.vg.acquire()
    e2 = s._engine_for(v2, "torch")
    assert e2.n > e1.n
    d = s.vg.delta_between(v1, v2)
    _assert_same(talg.incremental_bfs(e2, SOURCES, p1, d1, d), talg.bfs_multi(e2, SOURCES))
    _assert_same(talg.incremental_connected_components(e2, labels, d),
                 talg.connected_components(e2))
    s.vg.release(v1)
    s.vg.release(v2)


# ---------------------------------------------------------------------------
# (3) subscriptions
# ---------------------------------------------------------------------------


def test_subscriptions_stay_fresh_like_the_reference(base_edges, batch):
    """Three insert hops and a deletion hop, refreshed after each: the same
    path counts as the reference's subscriptions, bfs and cc bit-identical
    to them and to a full recompute, PageRank within 1e-6."""
    s, r = _port(base_edges), _ref(base_edges)
    src = np.array([0, 31], np.int64)
    subs = {}
    for who, stream, backend in (("port", s, "torch"), ("ref", r, "jax")):
        subs[who] = [stream.subscribe("bfs", sources=src, backend=backend),
                     stream.subscribe("cc", backend=backend),
                     stream.subscribe("pagerank", backend=backend, tol=1e-6)]
    for i in range(3):
        for stream in (s, r):
            stream.insert_edges(batch[2 * i:2 * i + 2])
        for sub in subs["port"] + subs["ref"]:
            sub.refresh()
    for stream in (s, r):
        stream.delete_edges(base_edges[:5], symmetric=False)
    for sub in subs["port"] + subs["ref"]:
        sub.refresh()
        assert sub.stamp == 4
    (bfs, cc, pr), (rbfs, rcc, rpr) = subs["port"], subs["ref"]
    assert (bfs.n_full, bfs.n_incremental) == (rbfs.n_full, rbfs.n_incremental) == (1, 4)
    assert (pr.n_full, pr.n_incremental) == (rpr.n_full, rpr.n_incremental) == (1, 4)
    # cc took the incremental path on inserts, full on the deletion hop
    assert (cc.n_full, cc.n_incremental) == (rcc.n_full, rcc.n_incremental) == (2, 3)
    eng = s.engine("torch")
    _assert_same(bfs.value, rbfs.value)
    _assert_same(bfs.value, talg.bfs_multi(eng, src))
    _assert_same(cc.value, rcc.value)
    _assert_same(cc.value, np.asarray(talg.connected_components(eng), np.int64))
    np.testing.assert_allclose(pr.value, rpr.value, rtol=0, atol=PR_ATOL)
    np.testing.assert_allclose(pr.value, talg.pagerank(eng, tol=1e-6), rtol=0, atol=PR_ATOL)
    for sub in subs["port"] + subs["ref"]:
        sub.close()


def test_subscription_weighted_sssp(base_edges, batch):
    w = _weights_for(base_edges)
    s, r = _port(base_edges, w), _ref(base_edges, w)
    src = np.array([3, 200], np.int64)
    with s.subscribe("sssp", sources=src) as sub, r.subscribe("sssp", sources=src) as rsub:
        for stream in (s, r):
            stream.insert_edges(batch, weights=_weights_for(batch))
        sub.refresh()
        rsub.refresh()
        for stream in (s, r):
            stream.delete_edges(base_edges[:10], symmetric=False)
        sub.refresh()
        rsub.refresh()
        assert sub.n_incremental == rsub.n_incremental == 2
        assert isinstance(s.engine("torch"), TorchEngine)
        np.testing.assert_array_equal(sub.value, talg.sssp_multi(s.engine("torch"), src))
        np.testing.assert_array_equal(sub.value, rsub.value)


def test_subscription_full_fallback_on_broken_chain(base_edges, batch):
    s = _port(base_edges)
    sub = s.subscribe("bfs", sources=[0])
    # two hops land before the subscriber catches up; the first is
    # collected at once => delta chain broken => full recompute
    s.insert_edges(batch[:2])
    s.insert_edges(batch[2:4])
    sub.refresh()
    assert sub.n_full == 2 and sub.n_incremental == 0
    np.testing.assert_array_equal(sub.value[1], talg.bfs_multi(s.engine("torch"), [0])[1])
    # a vertex op publishes no delta: full again, never a wrong answer
    s.insert_vertices(np.array([N + 1]))
    sub.refresh()
    assert sub.n_full == 3
    np.testing.assert_array_equal(sub.value[0], talg.bfs_multi(s.engine("torch"), [0])[0])
    sub.close()


def test_subscription_close_idempotent_and_guards(base_edges):
    s = _port(base_edges)
    sub = s.subscribe("cc")
    held_stamp = sub.stamp
    assert s.vg.live_versions() == 1
    sub.close()
    sub.close()  # idempotent
    with pytest.raises(RuntimeError):
        sub.refresh()
    with pytest.raises(ValueError):
        s.subscribe("nope")
    with pytest.raises(ValueError):
        s.subscribe("bfs")  # sources required
    assert held_stamp == 0
    s.insert_edges(np.array([[1, 2]]))
    assert s.vg.live_versions() == 1  # the closed subscription pinned nothing


def test_refresh_on_a_fresh_subscription_is_a_noop(base_edges):
    s = _port(base_edges)
    with s.subscribe("bfs", sources=[5]) as sub:
        before = sub.value
        assert all(a is b for a, b in zip(sub.refresh(), before))
        assert (sub.n_full, sub.n_incremental) == (1, 0)


# ---------------------------------------------------------------------------
# (4) publish listeners
# ---------------------------------------------------------------------------


def test_publish_listener_fires_outside_the_write_lock_and_unsubscribes():
    s = tst.AspenStream(tG.build_graph(8, np.array([[0, 1]])), device="cpu")
    seen = []

    def listener(v):
        # outside the write lock: the listener can take it, and acquire
        assert s._wlock.acquire(blocking=False)
        s._wlock.release()
        seen.append((v.stamp, s.vg.current_stamp))

    def broken(v):
        raise RuntimeError("a listener bug never blocks the writer")

    unsub = s.on_publish(listener)
    unsub_broken = s.on_publish(broken)
    s.insert_edges(np.array([[1, 2]]))
    s.delete_edges(np.array([[1, 2]]))
    assert seen == [(1, 1), (2, 2)]
    unsub()
    unsub()  # idempotent
    unsub_broken()
    s.insert_edges(np.array([[2, 3]]))
    assert seen == [(1, 1), (2, 2)]  # unsubscribed: no further calls
    assert s.vg.current_stamp == 3


def test_default_backend_is_torch(base_edges):
    s = _port(base_edges)
    assert s._default_backend() == "torch"
    with s.subscribe("cc") as sub:
        assert isinstance(s._engine_for(sub._v, "torch"), TorchEngine)


# ---------------------------------------------------------------------------
# (5) a compressed mirror
# ---------------------------------------------------------------------------


def test_subscriptions_on_a_compressed_stream(base_edges, batch):
    """Subscriptions over ``CompressedEngine``: each refresh incremental,
    bfs / cc / sssp bit-identical to the reference's numpy engine on the
    same edges, PageRank within 1e-6 of the raw torch engine."""
    s = _port(base_edges, compressed=True)
    r = _ref(base_edges)
    raw = _port(base_edges)
    src = np.array([0, 31], np.int64)
    subs = {k: s.subscribe(k, sources=src) for k in ("bfs", "cc", "sssp")}
    subs["pagerank"] = s.subscribe("pagerank", tol=1e-6)
    assert isinstance(s.engine("torch"), CompressedEngine)
    for i in range(2):
        for stream in (s, r, raw):
            stream.insert_edges(batch[4 * i:4 * i + 4])
        for sub in subs.values():
            sub.refresh()
    ref = r.engine("numpy")
    for kind, sub in subs.items():
        assert (sub.n_full, sub.n_incremental) == (1, 2), kind
    _assert_same(subs["bfs"].value, jalg.bfs_multi(ref, src))
    _assert_same(subs["cc"].value, np.asarray(jalg.connected_components(ref), np.int64))
    _assert_same(subs["sssp"].value, jalg.sssp_multi(ref, src))
    np.testing.assert_allclose(subs["pagerank"].value,
                               talg.pagerank(raw.engine("torch"), tol=1e-6), rtol=0, atol=PR_ATOL)
    for sub in subs.values():
        sub.close()


def test_delta_chain_composes_across_held_hops(base_edges, batch):
    s = _port(base_edges)
    v0 = s.vg.acquire()
    held = []
    for i in range(3):
        s.insert_edges(batch[i:i + 1])
        held.append(s.vg.acquire())
    d = s.vg.delta_between(v0, held[-1])
    assert isinstance(d, Delta) and d.ins.shape[0] == 6
    for v in [v0] + held:
        s.vg.release(v)
