"""The port's result cache and carry-forward (DESIGN.md §14).

The port runs on the CPU (``device="cpu"``, its kernels' plain versions).
Held:

  (1) the cache is version-keyed: payloads live on ``Version.cache`` and
      die with the version; capacity eviction deletes from the owning
      live version; a new version never sees an old version's entry;
  (2) submit-time hits bypass admission (the tenant ledger stays exact,
      the WFQ pass does not move);
  (3) a pinned ``Session`` is never served a newer version's answer;
  (4) carry-forward promotes hot entries through the exact incremental
      paths, equal to the reference's own carry-forward on the same
      edges, and falls back to a full recompute on a broken chain;
  (5) carry-forward stays incremental when the promotion thread runs
      several publishes behind the writer: the service records every
      hop's delta as it is published (the reference recomputes in full
      there);
  (6) lifecycle under 1k publishes: bounded ``live_versions``, early
      versions collected, hits;
  (7) answers with the cache on are bit-identical to the cache off,
      across a publish, on the torch and the numpy engine;
  (8) ``stats()`` is one consistent snapshot under a hammering reader;
  (9) the opt-in fastpath and the promotion capture.

Left out of the reference's file: its fastpath zero-retrace test (eager
torch traces nothing).  The sharded cache test runs 8 shard rows on one
device (the reference's needs an 8-device mesh).
"""
import gc
import threading
import time
import weakref

import numpy as np
import pytest
import torch

from repro.core import graph as jG
from repro.core.streaming import AspenStream as JaxStream
from repro.serve.graph import ResultCache as JaxCache
from repro_torch.core import graph as tG
from repro_torch.core.streaming import AspenStream
from repro_torch.core.traversal import ENGINE_BUILDS
from repro_torch.core.traversal import algorithms as talg
from repro_torch.core.versioning import DELTA, Delta
from repro_torch.data.rmat import rmat_edges, symmetrize
from repro_torch.serve.graph import GraphQueryService, ResultCache
from repro_torch.serve.graph.request import params_key

N = 256
NP = 32  # path-graph vertex count
T = 30  # seconds any one wait may take


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its tensors are small, and with
    several test workers on the machine torch's default pool oversubscribes
    the cores (a publish then takes tens of ms instead of one)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rmat_edge_list():
    return symmetrize(rmat_edges(8, 2000, seed=11))


def path_edges(n):
    e = np.array([[i, i + 1] for i in range(n - 1)], dtype=np.int64)
    return np.concatenate([e, e[:, ::-1]])


def make_stream(edges, n=N):
    return AspenStream(tG.build_graph(n, edges), device="cpu")


def make_service(edges, n=N, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("default_deadline_s", 0.25)
    stream = make_stream(edges, n=n)
    return stream, GraphQueryService(stream, **kw)


# ---------------------------------------------------------------------------
# (1) version keying, eviction, payload lifecycle
# ---------------------------------------------------------------------------


def test_cache_version_keyed_get_put():
    stream = make_stream(path_edges(NP), n=NP)
    cache = ResultCache(capacity=8)
    v1 = stream.acquire()
    val = np.arange(NP)
    cache.put(v1, "bfs", (), 3, val)
    ent = cache.get(v1, "bfs", (), 3)
    assert ent is not None and ent.value is val and ent.hits == 1
    assert cache.get(v1, "bfs", (), 4) is None
    assert cache.get(v1, "bfs", params_key({"x": 1}), 3) is None
    assert cache.get(v1, "sssp", (), 3) is None
    stream.insert_edges(np.array([[0, 5]]))
    v2 = stream.acquire()
    assert cache.get(v2, "bfs", (), 3) is None  # a NEW version never sees it
    snap = cache.snapshot()
    assert snap["fills"] == 1 and snap["hits"] == 1 and snap["misses"] == 4
    stream.release(v2)
    stream.release(v1)


def test_cache_capacity_eviction_deletes_from_live_version():
    stream = make_stream(path_edges(NP), n=NP)
    cache = ResultCache(capacity=4)
    v1 = stream.acquire()
    for s in range(6):
        cache.put(v1, "bfs", (), s, np.arange(NP) + s)
    assert cache.snapshot()["entries"] == 4 and cache.evictions == 2
    assert cache.get(v1, "bfs", (), 0) is None
    assert cache.get(v1, "bfs", (), 1) is None
    assert cache.get(v1, "bfs", (), 5) is not None
    stream.release(v1)
    with pytest.raises(ValueError):
        ResultCache(capacity=0)


def test_cache_payload_dies_with_version():
    stream = make_stream(path_edges(NP), n=NP)
    cache = ResultCache()
    v1 = stream.acquire()
    cache.put(v1, "bfs", (), 1, np.zeros(NP))
    ref = weakref.ref(v1)
    stream.release(v1)
    del v1
    stream.insert_edges(np.array([[0, 9]]))  # supersede: refcount 0 -> GC
    gc.collect()
    assert ref() is None
    small = ResultCache(capacity=1)
    v = stream.acquire()
    sref = weakref.ref(v)
    small.put(v, "bfs", (), 0, np.zeros(NP))
    stream.release(v)
    del v
    stream.insert_edges(np.array([[0, 11]]))
    gc.collect()
    assert sref() is None
    v2 = stream.acquire()
    small.put(v2, "bfs", (), 1, np.ones(NP))
    small.put(v2, "bfs", (), 2, np.ones(NP))
    assert small.evictions == 1  # only the live-owner eviction counted
    stream.release(v2)


# ---------------------------------------------------------------------------
# (2) submit-time hits
# ---------------------------------------------------------------------------


def test_submit_hit_bypasses_admission_but_meters_ledger(rmat_edge_list):
    stream, svc = make_service(rmat_edge_list)
    with svc:
        first = svc.query("bfs", source=3, tenant="a", timeout=T)
        vpass_after_miss = svc._admission.tenant("a").vpass
        t2 = svc.submit("bfs", source=3, tenant="a")
        assert t2.cached and t2.fastpath and t2.batch_size == 0
        assert np.array_equal(t2.result(timeout=T), first)
        assert svc._admission.tenant("a").vpass == vpass_after_miss
        st = svc.stats()
        ta = st["tenants"]["a"]
        assert ta["cached"] == 1
        assert ta["submitted"] == ta["completed"] == 2
        assert ta["submitted"] == ta["admitted"] + ta["rejected"] + ta["backlog"]
        assert st["lanes"]["bfs"]["cache_hits"] >= 1
        assert st["lanes"]["bfs"]["fastpath_hits"] == 1


def test_cc_and_pagerank_hit_on_repeat(rmat_edge_list):
    stream, svc = make_service(rmat_edge_list)
    with svc:
        cc1 = svc.query("cc", timeout=T)
        pr1 = svc.query("pagerank", timeout=T)
        t_cc, t_pr = svc.submit("cc"), svc.submit("pagerank")
        assert t_cc.cached and t_pr.cached
        assert np.array_equal(t_cc.result(timeout=T), cc1)
        assert np.array_equal(t_pr.result(timeout=T), pr1)


# ---------------------------------------------------------------------------
# (3) pinned sessions never see a newer version's cached result
# ---------------------------------------------------------------------------


def test_pinned_session_never_served_newer_cached_result():
    stream, svc = make_service(path_edges(NP), n=NP)
    with svc:
        with svc.session(tenant="t") as sess:
            first = sess.query("bfs", source=0).result(timeout=T)
            svc.insert_edges(np.array([[0, 20]]))
            svc.flush_updates(timeout=T)
            svc.flush_promotions(timeout=T)
            fresh = svc.query("bfs", source=0, timeout=T)
            assert not np.array_equal(fresh, first)  # the graph really changed
            tk = sess.query("bfs", source=0)
            assert np.array_equal(tk.result(timeout=T), first)
            assert tk.cached
            tk2 = svc.submit("bfs", source=0)
            assert np.array_equal(tk2.result(timeout=T), fresh)


# ---------------------------------------------------------------------------
# (4) carry-forward: exact, the reference's answers, full fallback
# ---------------------------------------------------------------------------


def _fill_hot(cache, stream, v, backend, alg, n):
    """Cache and touch one entry of each kind on ``v``."""
    eng = stream._engine_for(v, backend)
    p, d = alg.bfs_multi(eng, [0])
    cache.put(v, "bfs", (), 0, np.asarray(p[0]), state=np.asarray(d[0]))
    cache.put(v, "sssp", (), 0, np.asarray(alg.sssp_multi(eng, [0])[0], np.float64))
    cache.put(v, "cc", (), None, np.asarray(alg.connected_components(eng), np.int64))
    pr_pkey = params_key({"tol": 1e-6, "max_iters": 500})
    pr = alg.pagerank_multi(eng, resets=np.full((1, n), 1.0 / n), tol=1e-6, max_iters=500)
    cache.put(v, "pagerank", pr_pkey, None, np.asarray(pr[0]))
    keys = [("bfs", (), 0), ("sssp", (), 0), ("cc", (), None), ("pagerank", pr_pkey, None)]
    for kind, pkey, src in keys:
        assert cache.get(v, kind, pkey, src) is not None  # hot
    return keys


def test_carry_forward_promotes_hot_entries_exactly_like_the_reference():
    from repro.core.traversal import algorithms as jalg

    got = {}
    for who, stream, cache, backend, alg in (
            ("port", make_stream(path_edges(NP), n=NP), ResultCache(), "torch", talg),
            ("ref", JaxStream(jG.build_graph(NP, path_edges(NP))), JaxCache(), "jax", jalg)):
        v1 = stream.acquire()
        keys = _fill_hot(cache, stream, v1, backend, alg, NP)
        stream.insert_edges(np.array([[0, 20]]))
        v2 = stream.acquire()
        assert cache.carry_forward(stream, v1, v2, backend) == 4
        assert cache.promoted_incremental == 4  # bfs, sssp, cc (insert-only), tol pagerank
        got[who] = {k: cache.get(v2, *k) for k in keys}
        eng2 = stream._engine_for(v2, backend)
        ref_p, ref_d = alg.bfs_multi(eng2, [0])
        ent = got[who][keys[0]]
        assert np.array_equal(ent.value, ref_p[0]) and np.array_equal(ent.state, ref_d[0])
        assert np.array_equal(got[who][keys[1]].value, alg.sssp_multi(eng2, [0])[0])
        assert np.array_equal(got[who][keys[2]].value, alg.connected_components(eng2))
        cold = alg.pagerank_multi(eng2, resets=np.full((1, NP), 1.0 / NP), tol=1e-6,
                                  max_iters=500)
        np.testing.assert_allclose(got[who][keys[3]].value, cold[0], rtol=0, atol=1e-6)
        stream.release(v2)
        stream.release(v1)
    for k in keys[:3]:
        assert np.array_equal(got["port"][k].value, got["ref"][k].value), k
    np.testing.assert_allclose(got["port"][keys[3]].value, got["ref"][keys[3]].value,
                               rtol=0, atol=1e-6)


def test_carry_forward_cold_entries_stay_behind():
    stream = make_stream(path_edges(NP), n=NP)
    cache = ResultCache()
    v1 = stream.acquire()
    cache.put(v1, "bfs", (), 0, np.arange(NP), state=np.arange(NP))
    stream.insert_edges(np.array([[0, 20]]))
    v2 = stream.acquire()
    builds = ENGINE_BUILDS.count
    assert cache.carry_forward(stream, v1, v2, "torch") == 0  # never read: not hot
    assert ENGINE_BUILDS.count == builds  # and no engine work
    stream.release(v2)
    stream.release(v1)


def test_carry_forward_full_fallback_on_broken_chain():
    stream = make_stream(path_edges(NP), n=NP)
    cache = ResultCache()
    v1 = stream.acquire()
    p, d = talg.bfs_multi(stream._engine_for(v1, "torch"), [0])
    cache.put(v1, "bfs", (), 0, np.asarray(p[0]), state=np.asarray(d[0]))
    assert cache.get(v1, "bfs", (), 0) is not None
    stream.insert_vertices(np.array([NP + 8]))  # publishes no delta record
    v2 = stream.acquire()
    assert stream.vg.delta_between(v1, v2) is None
    assert cache.carry_forward(stream, v1, v2, "torch") == 1
    assert cache.promoted_full == 1 and cache.promoted_incremental == 0
    ref_p, _ = talg.bfs_multi(stream._engine_for(v2, "torch"), [0])
    assert np.array_equal(cache.get(v2, "bfs", (), 0).value, ref_p[0])
    stream.release(v2)
    stream.release(v1)


def test_carry_forward_drops_unknown_params():
    stream = make_stream(path_edges(NP), n=NP)
    cache = ResultCache()
    v1 = stream.acquire()
    pkey = params_key({"mystery": 1})
    cache.put(v1, "bfs", pkey, 0, np.arange(NP), state=np.arange(NP))
    cache.get(v1, "bfs", pkey, 0)
    stream.insert_edges(np.array([[0, 20]]))
    v2 = stream.acquire()
    assert cache.carry_forward(stream, v1, v2, "torch") == 0
    assert cache.promoted_dropped == 1
    assert cache.get(v2, "bfs", pkey, 0) is None  # never promoted wrong
    stream.release(v2)
    stream.release(v1)


def test_carry_forward_takes_a_given_delta_across_collected_hops():
    """With the hops in between collected, ``vg.delta_between`` is None
    (a full recompute); the caller's composed delta keeps it incremental."""
    stream = make_stream(path_edges(NP), n=NP)
    cache = ResultCache()
    v1 = stream.acquire()
    p, d = talg.bfs_multi(stream._engine_for(v1, "torch"), [0])
    cache.put(v1, "bfs", (), 0, np.asarray(p[0]), state=np.asarray(d[0]))
    cache.get(v1, "bfs", (), 0)
    deltas = [stream.insert_edges(np.array([[0, 10 + i]])).aux[DELTA] for i in range(3)]
    v2 = stream.acquire()
    assert stream.vg.delta_between(v1, v2) is None
    assert cache.carry_forward(stream, v1, v2, "torch", delta=Delta.concat(deltas)) == 1
    assert cache.promoted_incremental == 1 and cache.promoted_full == 0
    ref_p, _ = talg.bfs_multi(stream._engine_for(v2, "torch"), [0])
    assert np.array_equal(cache.get(v2, "bfs", (), 0).value, ref_p[0])
    stream.release(v2)
    stream.release(v1)


# ---------------------------------------------------------------------------
# (5) carry-forward behind the writer: the recorded hops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("promoter", ["in_step", "behind", "before_listener"])
def test_carry_forward_keeps_hot_entry_warm_across_publishes(rmat_edge_list, promoter):
    """Five back-to-back publishes, then the hot entry is served from the
    cache, promoted incrementally and never in full.  ``behind``: the
    promotion pass is held until all five have landed and their versions
    are collected, the interleaving in which the reference's promotion
    finds its chain broken and recomputes.  ``before_listener``: held as
    well, then let go after the fifth version is current but before its
    publish listeners run, so the pass holds a version whose hop the
    listener has not recorded yet."""
    stream, svc = make_service(rmat_edge_list)
    gate = threading.Event()
    if promoter == "in_step":
        gate.set()
    orig = svc._promote_once

    def gated():
        gate.wait(T)
        orig()

    svc._promote_once = gated
    if promoter == "before_listener":
        notify = stream._notify_publish

        def late_notify(v):
            if v.stamp == 5:  # the pass runs between vg.set and the listeners
                gate.set()
                end = time.perf_counter() + T
                while svc._anchor.stamp != 5 or svc._promoting:
                    assert time.perf_counter() < end, "the promotion pass did not run"
                    time.sleep(0.001)
            notify(v)

        stream._notify_publish = late_notify
    with svc:
        svc.query("bfs", source=3, timeout=T)
        svc.query("bfs", source=3, timeout=T)  # hot
        for _ in range(5):
            stream.insert_edges(np.array([[7, 11]]))
        if promoter == "behind":
            assert stream.vg.live_versions() == 2  # the anchor and the current one
            assert stream.vg.delta_between_stamps(0, 5) is None
            gate.set()
        svc.flush_promotions(timeout=T)
        before = svc.stats()["cache"]["hits"]
        t = svc.submit("bfs", source=3)
        t.result(timeout=T)
        st = svc.stats()["cache"]
        assert t.cached  # the promoted entry served the post-publish repeat
        assert st["promoted_incremental"] >= 1 and st["promoted_full"] == 0
        assert st["promoted_dropped"] == 0 and st["promote_errors"] == 0
        assert st["hits"] == before + 1
        assert svc._hops == {}  # the recorded hops go with the rotation
    np.testing.assert_array_equal(t.result(timeout=T), stream.query_batch([3], kind="bfs")[0])


# ---------------------------------------------------------------------------
# (6) lifecycle under a live writer
# ---------------------------------------------------------------------------


def test_cache_lifecycle_1k_publishes_no_leaks(rmat_edge_list):
    stream, svc = make_service(rmat_edge_list, backend="numpy")
    rng = np.random.default_rng(3)
    version_refs = []
    with svc:
        for i in range(1000):
            stream.insert_edges(np.array([[int(rng.integers(N)), int(rng.integers(N))]]))
            if i % 10 == 0:
                src = int(min(rng.zipf(2.0) - 1, N - 1))
                svc.query("bfs", source=src, timeout=T)
                svc.query("bfs", source=src, timeout=T)  # a same-version hit: hot
            if i % 100 == 0:
                v = stream.acquire()
                version_refs.append(weakref.ref(v))
                stream.release(v)
        svc.flush_promotions(timeout=T)
        st = svc.stats()
        assert st["live_versions"] <= 3
        assert st["cache"]["hits"] > 0 and st["cache"]["hit_rate"] > 0
        assert st["cache"]["promote_errors"] == 0
        assert len(svc._hops) == 0
    gc.collect()
    dead = sum(1 for r in version_refs if r() is None)
    assert dead >= len(version_refs) - 2  # only the newest may survive
    assert stream.vg.live_versions() == 1  # anchor released on stop


# ---------------------------------------------------------------------------
# (7) cache on == cache off, bit-identical, across a publish
# ---------------------------------------------------------------------------

REPLAY = [
    ("bfs", 3), ("sssp", 5), ("bfs", 3), ("cc", None),
    ("pagerank", None), ("bfs", 3), ("sssp", 5), ("pagerank", None),
]


def _run_replay(svc, publish_edges):
    out = [np.asarray(svc.query(kind, source=src, timeout=T)) for kind, src in REPLAY]
    svc.insert_edges(publish_edges)
    svc.flush_updates(timeout=T)
    svc.flush_promotions(timeout=T)
    return out + [np.asarray(svc.query(kind, source=src, timeout=T)) for kind, src in REPLAY]


@pytest.mark.parametrize("backend", [None, "numpy"])
def test_cached_bit_identical_to_uncached(rmat_edge_list, backend):
    publish = np.array([[3, 200], [200, 210]])
    got = {}
    for cache_on in (False, True):
        stream = make_stream(rmat_edge_list)
        svc = GraphQueryService(stream, backend=backend, max_batch=8,
                                result_cache=cache_on, fastpath=cache_on)
        with svc:
            got[cache_on] = _run_replay(svc, publish)
            st = svc.stats()["cache"]
            if cache_on:
                assert st["hits"] > 0 and st["promoted_incremental"] > 0
                assert st["promoted_dropped"] == 0 and st["promote_errors"] == 0
            else:
                assert st is None
    for a, b in zip(got[False], got[True]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_cached_bit_identical_sharded(rmat_edge_list):
    publish = np.array([[3, 200], [200, 210]])
    got = {}
    for cache_on in (False, True):
        stream = AspenStream(tG.build_graph(N, rmat_edge_list), mirror="sharded", n_shards=8,
                             device="cpu")
        svc = GraphQueryService(stream, backend="sharded", max_batch=4, result_cache=cache_on)
        with svc:
            got[cache_on] = _run_replay(svc, publish)
            if cache_on:
                assert svc.stats()["cache"]["hits"] > 0
    for a, b in zip(got[False], got[True]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# (8) stats() is one consistent snapshot
# ---------------------------------------------------------------------------


def test_stats_consistent_snapshot_under_hammering_reader(rmat_edge_list):
    stream, svc = make_service(rmat_edge_list, max_batch=4)
    bad = []
    stop = threading.Event()

    def hammer():
        while not stop.is_set():
            st = svc.stats()
            for name, t in st["tenants"].items():
                if t["submitted"] != t["admitted"] + t["rejected"] + t["backlog"]:
                    bad.append(("ledger", name, t))
                if t["admitted"] != t["completed"] + t["in_flight"]:
                    bad.append(("inflight", name, t))
            for k, m in st["lanes"].items():
                if m["flushed_requests"] != sum(s * c for s, c in m["batch_size_hist"].items()):
                    bad.append(("hist", k, m))

    with svc:
        th = threading.Thread(target=hammer)
        th.start()
        try:
            rng = np.random.default_rng(7)
            tickets = [svc.submit("bfs", source=int(rng.integers(0, 16)), tenant=f"t{i % 3}")
                       for i in range(300)]
            for t in tickets:
                t.result(timeout=T)
            svc.wait_idle(timeout=T)
        finally:
            stop.set()
            th.join(timeout=T)
        assert not th.is_alive()
        assert svc.stats()["cache"]["hits"] > 0  # the mix exercised hits
    assert not bad, bad[:3]


# ---------------------------------------------------------------------------
# (9) the fastpath and the promotion capture
# ---------------------------------------------------------------------------


def test_fastpath_serves_idle_singleton_on_caller_thread(rmat_edge_list):
    stream, svc = make_service(rmat_edge_list, fastpath=True)
    with svc:
        first = svc.query("bfs", source=3, timeout=T)
        st = svc.stats()
        assert st["lanes"]["bfs"]["fastpath_syncs"] == 1
        assert st["lanes"]["bfs"]["flushed_batches"] == 0  # no executor hop
        t = st["tenants"]["default"]
        assert t["submitted"] == t["admitted"] == t["completed"] == 1
        tk = svc.submit("bfs", source=3)
        assert tk.cached
        assert np.array_equal(tk.result(timeout=T), first)
    assert np.array_equal(first, stream.query_batch([3], kind="bfs")[0])


def test_capture_rides_inflight_promotion(rmat_edge_list):
    stream, svc = make_service(rmat_edge_list)
    svc.CAPTURE_WAIT_S = 10.0
    gate = threading.Event()      # holds the promotion pass open
    entered = threading.Event()   # the pass is in flight
    parked = threading.Event()    # the miss chose the capture path
    orig_carry = svc._cache.carry_forward

    def slow_carry(*a, **kw):
        entered.set()
        gate.wait(T)
        return orig_carry(*a, **kw)

    svc._cache.carry_forward = slow_carry
    orig_wait = svc._capture_wait

    def spy_wait(ticket, session, stamp):
        parked.set()
        return orig_wait(ticket, session, stamp)

    svc._capture_wait = spy_wait
    out = {}
    with svc:
        svc.query("bfs", source=3, timeout=T)
        svc.query("bfs", source=3, timeout=T)  # hot on the anchor
        vpass_before = svc._admission.tenant("default").vpass
        stream.insert_edges(np.array([[3, 40]]))  # publish -> the pass wakes
        assert entered.wait(T)

        def go():
            t = svc.submit("bfs", source=3, deadline_s=20.0)
            out["value"] = t.result(timeout=T)
            out["ticket"] = t

        th = threading.Thread(target=go)
        th.start()
        assert parked.wait(T)  # the miss rides the pass, not a lane
        gate.set()
        th.join(timeout=T)
        assert not th.is_alive() and "value" in out
        tk = out["ticket"]
        assert tk.cached and tk.fastpath and tk.batch_size == 0
        st = svc.stats()
        assert st["lanes"]["bfs"]["capture_hits"] == 1
        assert st["cache"]["promoted_incremental"] >= 1
        assert st["cache"]["promote_errors"] == 0
        assert svc._admission.tenant("default").vpass == vpass_before
    assert np.array_equal(out["value"], stream.query_batch([3], kind="bfs")[0])
