"""The port's GraphQueryService against the reference's (DESIGN.md §13).

Both services run over streams built from the same numpy edges; the
port's on the CPU (``device="cpu"``, its kernels' plain versions), the
reference's on its jax engine.  Held:

  (1) served answers equal the reference service's on the same version:
      bfs, sssp and cc bit-identical, PageRank within atol 1e-6
      (DESIGN.md §5), on the torch and the numpy engine;
  (2) admission is weighted-fair and respects in-flight caps and
      backlog backpressure (``QueueFull``);
  (3) the flush policy: full-lane, deadline and work-conserving flushes;
  (4) ``Session`` pinning is strictly serializable, and sessions leak
      no version refs;
  (5) the shape bookkeeping: the warmup ladder covers steady-state
      serving, and a pool that grew its capacity shows as a new shape;
  (6) ``drain_updates`` / ``UpdateQueue`` under the service's writer;
  (7) on the card (``cuda``): answers equal ``query_batch`` on the
      version, and kernel calls from several host threads on one stream
      equal their plain versions.

Every wait has its own timeout and every service runs in a ``with``
block, so a hang fails one test.  Left out of the reference's file: the
zero-retrace gate (eager torch traces nothing; ``TRACES`` stays 0).  The
sharded session test runs 8 shard rows on one device (the reference's
needs an 8-device mesh).
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import graph as jG
from repro.core.streaming import AspenStream as JaxStream
from repro.serve.graph import GraphQueryService as JaxService
from repro_torch.core import graph as tG
from repro_torch.core.streaming import AspenStream, UpdateQueue, drain_updates
from repro_torch.core.traversal import TRACES, make_engine
from repro_torch.core.traversal import algorithms as talg
from repro_torch.data.rmat import rmat_edges, symmetrize
from repro_torch.serve.graph import KINDS, GraphQueryService, QueueFull
from repro_torch.serve.graph.admission import AdmissionQueue
from repro_torch.serve.graph.request import QueryTicket

N = 256
PR_ATOL = 1e-6
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
    return symmetrize(rmat_edges(8, 2000, seed=11))  # 256 vertices


def make_stream(edges, **kw):
    kw.setdefault("device", "cpu")
    return AspenStream(tG.build_graph(N, edges), **kw)


def make_service(edges, **kw):
    kw.setdefault("max_batch", 8)
    kw.setdefault("default_deadline_s", 0.25)
    stream = make_stream(edges)
    return stream, GraphQueryService(stream, **kw)


QUERIES = [("bfs", 3), ("bfs", 77), ("sssp", 5), ("pagerank", None), ("pagerank", 9),
           ("cc", None), ("bfs", 3)]


def _serve_all(svc, queries):
    tickets = [svc.submit(kind, source=src) for kind, src in queries]
    return [np.asarray(t.result(timeout=T)) for t in tickets]


def _assert_answers_equal(queries, got, want):
    for (kind, src), a, b in zip(queries, got, want):
        assert a.shape == b.shape == (N,), (kind, src)
        if kind == "pagerank":
            np.testing.assert_allclose(a, b, rtol=0, atol=PR_ATOL, err_msg=f"{kind} {src}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{kind} {src}")


# ---------------------------------------------------------------------------
# (1) served answers == the reference service's answers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_answers(rmat_edge_list):
    """The reference service's answers on its jax engine, before and after
    one publish."""
    stream = JaxStream(jG.build_graph(N, rmat_edge_list))
    with JaxService(stream, backend="jax", max_batch=8) as svc:
        before = _serve_all(svc, QUERIES)
        svc.insert_edges(np.array([[3, 200], [200, 210]]))
        svc.flush_updates(timeout=T)
        after = _serve_all(svc, QUERIES)
    return before, after


@pytest.mark.parametrize("backend", [None, "numpy"])
def test_served_answers_match_reference_service(rmat_edge_list, reference_answers, backend):
    stream, svc = make_service(rmat_edge_list, backend=backend)
    with svc:
        assert svc.backend == (backend or "torch")
        before = _serve_all(svc, QUERIES)
        svc.insert_edges(np.array([[3, 200], [200, 210]]))
        svc.flush_updates(timeout=T)
        after = _serve_all(svc, QUERIES)
        assert svc.stats()["publishes"] == 1
    _assert_answers_equal(QUERIES, before, reference_answers[0])
    _assert_answers_equal(QUERIES, after, reference_answers[1])
    # and the port's own query_batch on the served version
    np.testing.assert_array_equal(after[0], stream.query_batch([3], kind="bfs")[0])
    np.testing.assert_array_equal(after[2], stream.query_batch([5], kind="sssp")[0])


def test_duplicate_sources_one_compute_fan_out(rmat_edge_list):
    stream, svc = make_service(rmat_edge_list, default_deadline_s=0.5)
    with svc:
        ts = [svc.submit("bfs", source=7) for _ in range(6)]
        rows = [t.result(timeout=T) for t in ts]
        st = svc.stats()["lanes"]["bfs"]
    ref = stream.query_batch([7], kind="bfs")[0]
    for r in rows:
        assert np.array_equal(r, ref)
    # one dispatch served every duplicate (the rest rode it or the cache)
    assert st["flushed_batches"] + st["cache_hits"] >= 1
    assert st["flushed_requests"] + st["cache_hits"] == 6


def test_ticket_validation(rmat_edge_list):
    stream, svc = make_service(rmat_edge_list)
    with svc:
        with pytest.raises(ValueError):
            svc.submit("bfs")  # source required
        with pytest.raises(ValueError):
            svc.submit("nope", source=0)
    with pytest.raises(RuntimeError):
        svc.submit("bfs", source=0)  # stopped service rejects
    assert KINDS == ("bfs", "sssp", "pagerank", "cc")


# ---------------------------------------------------------------------------
# (2) weighted fairness, in-flight caps, backpressure
# ---------------------------------------------------------------------------


def test_weighted_fair_admission(rmat_edge_list):
    """A 3:1 weight split admits exactly 15:5 of a saturated backlog, and
    end to end everything completes despite the contention."""
    q = AdmissionQueue(weights={"heavy": 3.0, "light": 1.0},
                       max_inflight_per_tenant=100, max_inflight_total=1000)
    for i in range(40):
        q.submit(QueryTicket("heavy", "bfs", i, {}, deadline=1e18))
        q.submit(QueryTicket("light", "bfs", i, {}, deadline=1e18))
    first = q.admit(max_n=20)
    assert sum(t.tenant == "heavy" for t in first) == 15
    assert sum(t.tenant == "light" for t in first) == 5

    stream, svc = make_service(rmat_edge_list, tenant_weights={"heavy": 3.0, "light": 1.0},
                               max_batch=4, max_inflight_total=4, default_deadline_s=10.0)
    with svc:
        ts = [svc.submit("bfs", source=i % N, tenant="heavy") for i in range(12)]
        ts += [svc.submit("bfs", source=i % N, tenant="light") for i in range(12)]
        for t in ts:
            t.result(timeout=T)
        st = svc.stats()
    assert st["tenants"]["heavy"]["completed"] == 12
    assert st["tenants"]["light"]["completed"] == 12


def test_inflight_caps_and_backpressure():
    q = AdmissionQueue(max_inflight_per_tenant=2, max_inflight_total=3, max_backlog=4)
    for i in range(4):
        q.submit(QueryTicket("a", "bfs", i, {}, deadline=1e18))
    with pytest.raises(QueueFull):
        q.submit(QueryTicket("a", "bfs", 9, {}, deadline=1e18))
    for i in range(2):
        q.submit(QueryTicket("b", "bfs", i, {}, deadline=1e18))
    admitted = q.admit()
    # per-tenant cap (2) binds for a; global cap (3) leaves b one slot
    assert sum(t.tenant == "a" for t in admitted) == 2
    assert sum(t.tenant == "b" for t in admitted) == 1
    assert q.admit() == []  # everything capped
    q.complete(admitted[0])
    assert len(q.admit()) == 1  # a completion frees exactly one slot


# ---------------------------------------------------------------------------
# (3) flush policy
# ---------------------------------------------------------------------------


def test_full_lane_flushes_at_max_batch(rmat_edge_list):
    stream, svc = make_service(rmat_edge_list, max_batch=4, default_deadline_s=30.0)
    with svc:
        svc.warmup(kinds=("bfs",))
        ts = [svc.submit("bfs", source=i) for i in range(8)]
        for t in ts:
            t.result(timeout=T)
        lane = svc.stats()["lanes"]["bfs"]
    # 30 s budgets mean nothing flushed early: both batches went out full
    assert lane["full_flushes"] >= 2
    assert lane["batch_size_hist"].get(4, 0) >= 2
    for t in ts:
        assert t.batch_size == 4
        assert t.deadline_missed is False


def test_work_conserving_flushes_idle_executor(rmat_edge_list):
    stream, svc = make_service(rmat_edge_list, max_batch=64, default_deadline_s=30.0,
                               work_conserving=True)
    with svc:
        svc.warmup(kinds=("bfs",))
        t = svc.submit("bfs", source=1)
        t.result(timeout=T)
        st = svc.stats()
    assert t.latency_s < 5.0  # nowhere near the 15 s half-budget mark
    assert st["lanes"]["bfs"]["idle_flushes"] >= 1


def test_deadline_flush_before_slo(rmat_edge_list):
    stream, svc = make_service(rmat_edge_list, max_batch=64, default_deadline_s=0.3)
    with svc:
        svc.warmup(kinds=("bfs",))
        t = svc.submit("bfs", source=1)  # alone in its lane: never fills
        r = t.result(timeout=T)
        st = svc.stats()
    assert r.shape == (N,)
    assert st["lanes"]["bfs"]["deadline_flushes"] >= 1
    # the half-budget rule waited ~0.15 s but answered within the SLO
    assert t.latency_s >= 0.1 and t.deadline_missed is False


# ---------------------------------------------------------------------------
# (4) session pinning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", [None, "numpy"])
def test_session_strictly_serializable(rmat_edge_list, backend):
    """A pinned session interleaved with publishes answers every read from
    its open-time version, equal to ``query_batch`` on that version, while
    unpinned reads see the new edges."""
    stream, svc = make_service(rmat_edge_list, backend=backend)
    with svc:
        with svc.session(tenant="t") as sess:
            stamp0 = sess.stamp
            eng0 = stream._engine_for(sess.version, backend or "torch")
            bfs0 = sess.query("bfs", source=3).result(timeout=T)
            sssp0 = sess.query("sssp", source=3).result(timeout=T)
            pr0 = sess.query("pagerank").result(timeout=T)
            cc0 = sess.query("cc").result(timeout=T)
            np.testing.assert_array_equal(bfs0, talg.bfs_multi(eng0, [3])[0][0])
            np.testing.assert_array_equal(sssp0, talg.sssp_multi(eng0, [3])[0])
            np.testing.assert_array_equal(cc0, talg.connected_components(eng0))
            for i in range(3):  # publish between every pair of session reads
                svc.insert_edges(np.array([[3, 200 + i], [200 + i, 210 + i]]))
                svc.flush_updates(timeout=T)
                for kind, want in (("bfs", bfs0), ("sssp", sssp0), ("pagerank", pr0),
                                   ("cc", cc0)):
                    got = sess.query(kind, source=3 if kind in ("bfs", "sssp") else None)
                    assert np.array_equal(got.result(timeout=T), want), kind
            assert sess.stamp == stamp0
            fresh = svc.submit("bfs", source=3).result(timeout=T)
        assert stream.vg.current_stamp > stamp0
        assert not np.array_equal(fresh, bfs0)  # unpinned reads advanced


def test_session_strictly_serializable_sharded(rmat_edge_list):
    """The same on a sharded stream served by the sharded engine: the
    session's reads stay on its version, equal to a flat engine there."""
    stream = make_stream(rmat_edge_list, mirror="sharded", n_shards=8)
    with GraphQueryService(stream, backend="sharded", max_batch=4) as svc:
        assert svc.backend == "sharded"
        with svc.session(tenant="t") as sess:
            bfs0 = sess.query("bfs", source=3).result(timeout=T)
            flat0 = make_engine(tG.flat_snapshot(sess.version.graph), backend="torch",
                                device="cpu")
            np.testing.assert_array_equal(bfs0, talg.bfs_multi(flat0, [3])[0][0])
            svc.insert_edges(np.array([[3, 200], [200, 210]]))
            svc.flush_updates(timeout=T)
            assert np.array_equal(sess.query("bfs", source=3).result(timeout=T), bfs0)
            fresh = svc.submit("bfs", source=3).result(timeout=T)
        assert not np.array_equal(fresh, bfs0)


def test_service_on_mirrorless_and_sharded_streams(rmat_edge_list):
    """The service's lanes over a stream with no mirror (each version's
    engine rebuilt from its tree) and over a sharded one: answers equal
    ``query_batch`` on the stream, and the shape key names the engine."""
    from repro_torch.serve.graph.lanes import engine_signature

    for kw, sig0 in (({"mirror": False}, "torch"), ({"mirror": "sharded", "n_shards": 4},
                                                     "sharded")):
        stream = make_stream(rmat_edge_list, **kw)
        with GraphQueryService(stream, max_batch=4) as svc:
            got = svc.submit("bfs", source=3).result(timeout=T)
            np.testing.assert_array_equal(got, stream.query_batch([3], kind="bfs")[0])
            sig = engine_signature(stream.engine(svc.backend))
            assert sig[0] == sig0 and sig[1] == N


def test_sessions_do_not_leak_versions(rmat_edge_list):
    """1k publishes with sessions opened and closed throughout leave no
    extra live versions once closed."""
    stream, svc = make_service(rmat_edge_list, backend="numpy")
    with svc:
        for i in range(1000):
            stream.insert_edges(np.array([[i % N, (i * 7 + 1) % N]]), symmetric=False)
            if i % 100 == 0:
                with svc.session(tenant="t") as s:
                    s.query("bfs", source=0).result(timeout=T)
        assert svc.stats()["sessions_open"] == 0
    assert stream.vg.live_versions() == 1  # only current survives


def test_session_close_is_idempotent_and_blocks_new_queries(rmat_edge_list):
    stream, svc = make_service(rmat_edge_list, backend="numpy")
    with svc:
        sess = svc.session(tenant="t")
        sess.query("bfs", source=0).result(timeout=T)
        sess.close()
        sess.close()  # idempotent
        with pytest.raises(RuntimeError):
            sess.query("bfs", source=0)


# ---------------------------------------------------------------------------
# (5) shape bookkeeping (the reference's retrace accounting, no jit here)
# ---------------------------------------------------------------------------


def test_warmup_covers_the_shape_ladder(rmat_edge_list):
    stream, svc = make_service(rmat_edge_list, max_batch=8)
    with svc:
        svc.warmup()
        rng = np.random.default_rng(0)
        tickets = []
        for _ in range(40):
            tickets.append(svc.submit("bfs", source=int(rng.integers(N))))
            tickets.append(svc.submit("sssp", source=int(rng.integers(N))))
        tickets.append(svc.submit("pagerank"))
        tickets.append(svc.submit("cc"))
        for t in tickets:
            t.result(timeout=T)
        st = svc.stats()
    assert st["warm"] and st["jit_traces"] == TRACES.count == 0
    for kind, lane in st["lanes"].items():
        assert lane["retraces"] == 0, (kind, lane)
        assert lane["trace_keys"] >= 1, kind


def test_capacity_growth_is_a_new_shape(rmat_edge_list):
    stream, svc = make_service(rmat_edge_list, max_batch=4)
    cap0 = stream.flat_graph().edge_capacity
    with svc:
        svc.warmup(kinds=("bfs",))
        rng = np.random.default_rng(1)
        while stream.flat_graph().edge_capacity == cap0:
            stream.insert_edges(rng.integers(0, N, (512, 2)))
        svc.submit("bfs", source=0).result(timeout=T)
        st = svc.stats()
    assert st["lanes"]["bfs"]["retraces"] >= 1


# ---------------------------------------------------------------------------
# (6) drain_updates / UpdateQueue under the service's writer
# ---------------------------------------------------------------------------


def test_drain_updates_batches_and_orders(rmat_edge_list):
    stream = make_stream(rmat_edge_list)
    v0 = stream.acquire()
    m0 = tG.num_edges(v0.graph)
    stream.release(v0)
    q = UpdateQueue()
    # insert applies before the delete within one drain: the pair cancels
    q.put(1, 240)
    q.put(1, 240, delete=True)
    stamp0 = stream.vg.current_stamp
    assert drain_updates(q, stream, max_batch=10) == 2
    v1 = stream.acquire()
    assert tG.num_edges(v1.graph) == m0
    stream.release(v1)
    assert stream.vg.current_stamp > stamp0
    assert drain_updates(q, stream, max_batch=10) == 0  # empty: no-op


def test_drain_updates_weight_lane():
    stream = AspenStream(tG.build_graph(8, np.array([[0, 1]])), device="cpu")
    q = UpdateQueue()
    q.put(2, 3, weight=2.5)
    q.put(4, 5)  # weight-less row in a mixed batch rides with unit fill
    assert drain_updates(q, stream, max_batch=10) == 2
    assert stream.engine("torch").weighted
    assert stream.query_batch([2], kind="sssp")[0][3] == 2.5
    assert stream.query_batch([4], kind="sssp")[0][5] == 1.0


def test_update_queue_backpressure_and_stats():
    q = UpdateQueue(maxsize=2)
    assert q.put(0, 1, block=False)
    assert q.put(1, 2, block=False)
    assert not q.put(2, 3, block=False)  # full: rejected, counted
    st = q.stats()
    assert st["rejected"] == 1 and st["depth"] == 2 and st["high_water"] == 2
    assert len(q.pop_batch(10)) == 2 and len(q) == 0


def test_update_queue_put_many_goes_in_whole():
    q = UpdateQueue(maxsize=4)
    assert q.put_many(np.array([[0, 1, 0], [1, 2, 1]]))
    assert q.put_many([(2, 3, False, 2.5)])
    assert not q.put_many([(3, 4), (4, 5)], block=False)  # 3 + 2 > 4: none goes in
    assert not q.put_many([(3, 4), (4, 5)], timeout=0.01)
    with pytest.raises(ValueError):
        q.put_many([(0, 1)] * 5)
    st = q.stats()
    assert st["rejected"] == 4 and st["depth"] == 3 and st["enqueued"] == 3
    assert q.pop_batch(10) == [(0, 1, False, None), (1, 2, True, None), (2, 3, False, 2.5)]
    stream = AspenStream(tG.build_graph(8, np.array([[0, 1]])), device="cpu")
    stamp = stream.vg.current_stamp
    q.put_many([(2, 3), (4, 5)])
    assert drain_updates(q, stream, max_batch=2) == 2
    assert stream.vg.current_stamp == stamp + 1  # one batch, one publish


def test_launch_with_scratch_counts_each_key_once():
    from repro_torch.kernels import _build

    counts = {"a": 0, "b": 0, "c": 0}
    assert _build.launch_with_scratch(lambda: "out", counts, "a", "b") == "out"
    assert counts == {"a": 1, "b": 1, "c": 0}
    def fail():
        raise RuntimeError("launch failed")

    with pytest.raises(RuntimeError):  # a failed launch counts nothing
        _build.launch_with_scratch(fail, counts, "c")
    assert counts["c"] == 0


def test_service_under_live_writer(rmat_edge_list):
    """Mixed queries from two tenants racing a continuous writer:
    everything completes, the writer publishes through the service's
    queue, and the stats add up."""
    stream, svc = make_service(rmat_edge_list, default_deadline_s=1.0, update_batch=16)
    rng = np.random.default_rng(7)
    with svc:
        svc.warmup(kinds=("bfs", "sssp"))
        stop = threading.Event()

        def writer():
            i = 0
            while not stop.is_set():
                svc.enqueue_update(int(rng.integers(N)), int(rng.integers(N)),
                                   delete=(i % 5 == 4), block=False)
                i += 1
                time.sleep(0.001)

        wt = threading.Thread(target=writer)
        wt.start()
        try:
            tickets = [svc.submit("bfs" if i % 2 else "sssp", source=int(rng.integers(N)),
                                  tenant="a" if i % 3 else "b") for i in range(60)]
            results = [t.result(timeout=T) for t in tickets]
        finally:
            stop.set()
            wt.join(timeout=T)
        assert not wt.is_alive()
        svc.flush_updates(timeout=T)
        st = svc.stats()
    assert len(results) == 60 and all(r.shape == (N,) for r in results)
    assert st["publishes"] >= 1 and st["updates"]["drained"] == st["updates"]["enqueued"]
    assert st["admission"]["in_flight"] == 0 and st["admission"]["backlog"] == 0
    assert sum(v["completed"] for v in st["tenants"].values()) == 60
    assert st["cache"]["promoted_dropped"] == 0 and st["cache"]["promote_errors"] == 0


# ---------------------------------------------------------------------------
# (7) on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run: python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_served_answers_on_the_card(cuda, rmat_edge_list):
    from repro_torch.kernels import segment_reduce as sr

    stream = make_stream(rmat_edge_list, device=cuda)
    with GraphQueryService(stream, max_batch=8) as svc:
        svc.warmup()
        before = sr.LAUNCHES["segment_sum"]
        with svc.session(tenant="t") as sess:
            got = {k: sess.query(k, source=3 if k in ("bfs", "sssp") else None).result(timeout=T)
                   for k in KINDS}
            eng = stream._engine_for(sess.version, "torch")
            np.testing.assert_array_equal(got["bfs"], stream.query_batch([3], kind="bfs")[0])
            np.testing.assert_array_equal(got["sssp"], talg.sssp_multi(eng, [3])[0])
            np.testing.assert_array_equal(got["cc"], talg.connected_components(eng))
            np.testing.assert_allclose(got["pagerank"], talg.pagerank_multi(eng)[0],
                                       rtol=0, atol=PR_ATOL)
        assert sr.LAUNCHES["segment_sum"] > before


@pytest.mark.cuda
def test_kernel_calls_from_threads_on_one_stream(cuda):
    """Segment sums launched from several host threads at once on the
    default stream: each call's pass and fix-up go out together, so every
    result equals its plain version."""
    from repro_torch.kernels import segment_reduce as sr

    gen = torch.Generator(device=cuda).manual_seed(0)
    cases = []
    for E, n_out, D in ((300_001, 20_000, 1), (65_537, 4_000, 8), (12_289, 900, 16)):
        dst = torch.sort(torch.randint(0, n_out, (E,), generator=gen, device=cuda)).values
        msg = torch.randn((E, D), generator=gen, device=cuda)
        cases.append((dst.to(torch.int32), msg, n_out))
    wants = [sr.segment_sum_sorted_plain(d, m, n) for d, m, n in cases]
    bad = []

    def hammer(i):
        for _ in range(50):
            d, m, n = cases[i % len(cases)]
            got = sr.segment_sum_sorted(d, m, n)
            want = wants[i % len(cases)]
            if not torch.allclose(got, want, rtol=1e-5, atol=1e-6 * float(want.abs().max())):
                bad.append(i)

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not bad
