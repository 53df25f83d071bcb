"""The graph query service across ``torch.distributed`` ranks, against one rank.

Every rank builds ``GraphQueryService(stream, backend="sharded", ...)``
over its own ``AspenStream(mirror="sharded", n_shards=8)``; rank 0 serves
and its collective lane broadcasts each op's descriptor, and the other
ranks run them (``serve/graph/collective.py``).  Each world size is one
spawn of gloo processes on the CPU (``spawn_ranks`` from
``test_torch_ranks.py``); the one-rank answers come from the same
scenario with no process group, in this process.

Counterparts of the reference's ``multidevice`` service tests
(``tests/test_serve_graph.py:287``, ``tests/test_result_cache.py:408``)
with the reference's exactness classes (DESIGN.md §5): BFS, CC and SSSP
on integer weights bit-identical to one rank, cached and uncached
answers bit-identical, PageRank within atol 1e-6.  Beside them: a replay
beside a writer with promotion passes and a subscription, after which
every rank logged the same ``(op, stamp)`` sequence; requests rank 0
rejects, and cache hits, never reach a follower; a service whose backend
and stream do not match across the ranks raises; and a follower killed
mid-run fails rank 0's next ticket with an error within
``KILL_FAIL_S``, never a hang.
"""
import multiprocessing
import os
import pickle
import threading
import time

import numpy as np
import pytest
import torch.distributed as dist

from repro_torch.core import graph as tG
from repro_torch.core.streaming import AspenStream
from repro_torch.data.rmat import rmat_edges, symmetrize
from repro_torch.launch import mesh as mesh_lib
from repro_torch.serve.graph import GraphQueryService
from repro_torch.serve.graph.collective import LaneFault

from test_torch_ranks import _run, _weights_for, spawn_ranks

N = 256
S = 8
T = 60.0
PUBLISH = np.array([[3, 200], [200, 210]])
REPLAY = [
    ("bfs", 3), ("sssp", 5), ("bfs", 3), ("cc", None),
    ("pagerank", None), ("bfs", 3), ("sssp", 5), ("pagerank", None), ("pagerank", 7),
]
# flush a lane as soon as the executor is idle, not at half the deadline
FAST = {"work_conserving": True}
KILL_AFTER_OPS = 6  # the killed follower dies on receiving this many descriptors
KILL_FAIL_S = 20.0  # rank 0's next ticket fails within this


def _stream(mirror="sharded") -> AspenStream:
    """The rMAT graph of the reference's tests, with integer weights on
    its edges (SSSP is exact on them)."""
    e = symmetrize(rmat_edges(8, 2000, seed=11))
    return AspenStream(tG.build_graph(N, e, weights=_weights_for(e)), mirror=mirror,
                       n_shards=S if mirror == "sharded" else None, device="cpu")


def _serve(svc: GraphQueryService, body):
    """``body(svc)`` on rank 0 inside ``with svc``; a follower runs the
    lane until rank 0 stops.  (rank 0's answer or None, the lane log)."""
    if dist.is_initialized() and dist.get_rank() != 0:
        svc.start()
        return None, svc.op_log
    with svc:
        out = body(svc)
    return out, svc.op_log


def _replay(svc):
    out = [np.asarray(svc.query(kind, source=src, timeout=T)) for kind, src in REPLAY]
    svc.insert_edges(PUBLISH)
    svc.flush_updates(timeout=T)
    svc.flush_promotions(timeout=T)
    return out + [np.asarray(svc.query(kind, source=src, timeout=T)) for kind, src in REPLAY]


def _session(svc):
    with svc.session(tenant="t") as sess:
        stamp0 = sess.stamp
        bfs0 = sess.query("bfs", source=3).result(timeout=T)
        sssp0 = sess.query("sssp", source=3).result(timeout=T)
        svc.insert_edges(PUBLISH)
        svc.flush_updates(timeout=T)
        after = [sess.query("bfs", source=3).result(timeout=T),
                 sess.query("sssp", source=3).result(timeout=T)]
        assert sess.stamp == stamp0
    fresh = svc.submit("bfs", source=3).result(timeout=T)
    return {"bfs0": bfs0, "sssp0": sssp0, "after": after, "fresh": fresh}


def _rejected(svc):
    """Requests rank 0 refuses, and a cache hit: none of them sends a
    descriptor (the lane's log does not grow)."""
    svc.query("bfs", source=11, timeout=T)
    svc.wait_idle(timeout=T)
    before = len(svc.op_log)
    with pytest.raises(ValueError):
        svc.submit("triangles", source=1)
    with pytest.raises(ValueError):
        svc.submit("bfs")  # bfs needs a source
    hit = svc.submit("bfs", source=11)
    assert hit.cached and hit.result(timeout=T) is not None
    return before, len(svc.op_log)


def _live_writer(svc):
    """Warmup, a pagerank subscription, hot queries beside a writer fed
    through the service's queue, promotion passes between publishes."""
    svc.warmup(kinds=("bfs", "sssp", "pagerank", "cc"))
    sub = svc.subscribe("pagerank")
    rng = np.random.default_rng(5)
    stop = threading.Event()

    def writer():  # a burst of 8 updates every 50 ms
        i = 0
        while not stop.is_set():
            svc.enqueue_update(int(rng.integers(N)), int(rng.integers(N)),
                               delete=(i % 5 == 4), block=False)
            i += 1
            time.sleep(0.05 if i % 8 == 0 else 0.0)

    wt = threading.Thread(target=writer)
    wt.start()
    try:
        for r in range(2):
            for _ in range(2):  # the second pass hits: its entries turn hot
                tickets = [svc.submit(kind, source=src) for kind, src in REPLAY]
                [t.result(timeout=T) for t in tickets]
            sub.refresh()
            time.sleep(0.05)
    finally:
        stop.set()
        wt.join(timeout=T)
    svc.flush_updates(timeout=T)
    svc.flush_promotions(timeout=T)
    for src in range(20, 34):  # more answers on one live version than the cache holds
        svc.query("bfs", source=src, timeout=T)
    for _ in range(2):  # hot entries, then one publish that promotes them
        [svc.query(kind, source=src, timeout=T) for kind, src in REPLAY]
    svc.insert_edges(PUBLISH)
    svc.flush_updates(timeout=T)
    svc.flush_promotions(timeout=T)
    value = sub.refresh()
    sub.close()
    st = svc.stats()
    return {"cache": st["cache"], "publishes": st["publishes"], "ranks": st["ranks"],
            "sub_stamp": st["version_stamp"], "sub_finite": bool(np.isfinite(value).all())}


def _mismatched() -> list:
    """A sharded stream with another backend, and the sharded backend over
    a flat stream: the error each construction raises (None: built)."""
    out = []
    for stream, backend in ((_stream(), "torch"), (_stream("flat"), "sharded")):
        try:
            GraphQueryService(stream, backend=backend)
            out.append(None)
        except ValueError:
            out.append("ValueError")
    return out


def serve_scenario() -> dict:
    """What every rank runs (and one rank runs here)."""
    out = {"mismatched": _mismatched()}
    for cache_on in (False, True):
        svc = GraphQueryService(_stream(), backend="sharded", max_batch=4, **FAST,
                                result_cache=cache_on, fastpath=cache_on)
        out[f"replay_{cache_on}"] = _serve(svc, _replay)
    out["session"] = _serve(GraphQueryService(_stream(), backend="sharded", max_batch=4,
                                              **FAST), _session)
    out["rejected"] = _serve(GraphQueryService(_stream(), backend="sharded", max_batch=4,
                                               fastpath=True, **FAST), _rejected)
    # a small cache: rank 0 evicts, and the followers' copies drop the same entries
    out["live"] = _serve(GraphQueryService(_stream(), backend="sharded", max_batch=4,
                                           fastpath=True, update_batch=16,
                                           cache_capacity=12, **FAST), _live_writer)
    return out


# ---------------------------------------------------------------------------
# the checks
# ---------------------------------------------------------------------------

WORLDS = [2, 4]


@pytest.fixture(scope="module")
def one_rank():
    assert not dist.is_initialized()
    return serve_scenario()


@pytest.fixture(scope="module", params=WORLDS, ids=[f"k{k}" for k in WORLDS])
def ranks(request, tmp_path_factory):
    k = request.param
    return k, spawn_ranks(serve_scenario, k, tmp_path_factory.mktemp(f"serve{k}"))


def _assert_answers(got, want, what):
    assert len(got) == len(want), what
    for i, (a, b) in enumerate(zip(got, want)):
        kind = (REPLAY * 2)[i][0]
        if kind == "pagerank":
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=f"{what} {i} {kind}")
        else:
            assert a.dtype == b.dtype, what
            np.testing.assert_array_equal(a, b, err_msg=f"{what} {i} {kind}")


def test_cached_bit_identical_sharded_ranks(ranks, one_rank):
    """The replay across ranks gives one rank's answers, cache on and
    off; cached and uncached answers are bit-identical to each other."""
    k, res = ranks
    for cache_on in (False, True):
        got = res[0][f"replay_{cache_on}"][0]
        _assert_answers(got, one_rank[f"replay_{cache_on}"][0], f"k={k} cache={cache_on}")
    for a, b in zip(res[0]["replay_False"][0], res[0]["replay_True"][0]):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_session_strictly_serializable_sharded_ranks(ranks, one_rank):
    """A session's reads across a publish see its pinned version on every
    rank (followers keep it until rank 0 releases it), and equal one
    rank's; a fresh read sees the publish."""
    k, res = ranks
    got, want = res[0]["session"][0], one_rank["session"][0]
    for key in ("bfs0", "sssp0", "fresh"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=f"k={k} {key}")
    np.testing.assert_array_equal(got["after"][0], got["bfs0"])
    np.testing.assert_array_equal(got["after"][1], got["sssp0"])
    assert not np.array_equal(got["fresh"], got["bfs0"])


@pytest.mark.parametrize("scenario", ["replay_False", "replay_True", "session", "rejected",
                                      "live"])
def test_every_rank_logs_the_same_ops(ranks, scenario):
    """Each follower ran rank 0's ops in rank 0's order, on versions of the
    same stamps (a publish logs the stamp it made on each rank)."""
    k, res = ranks
    log0 = res[0][scenario][1]
    assert log0 and log0[-1][0] == "stop"
    for r in range(1, k):
        assert res[r][scenario][1] == log0, f"k={k} rank {r} {scenario}"


def test_live_writer_promotes_without_errors(ranks):
    """Beside a writer, the promotion passes carry hot entries forward on
    every rank with no error or dropped entry, and the subscription
    stays finite."""
    k, res = ranks
    live, log = res[0]["live"]
    assert live["publishes"] >= 2
    cache = live["cache"]
    assert cache["promote_errors"] == 0 and cache["promoted_dropped"] == 0
    assert cache["promoted_incremental"] + cache["promoted_full"] >= 1, str(cache)
    assert cache["evictions"] >= 1, str(cache)
    assert live["sub_finite"]
    assert live["ranks"]["world"] == k and live["ranks"]["lane_error"] is None
    ops = {op for op, _ in log}
    assert {"warmup", "publish", "promote", "subscribe", "refresh", "unsubscribe"} <= ops
    assert ops & {"flush", "fast"}


def test_lane_needs_a_stream_sharded_across_the_ranks(ranks, one_rank):
    """Across ranks the service takes its lane from the stream's mesh:
    another backend over a stream sharded across the ranks, or the
    sharded backend over a flat stream, raises on every rank instead of
    running collectives no other rank joins; one rank builds both."""
    k, res = ranks
    for r in range(k):
        assert res[r]["mismatched"] == ["ValueError", "ValueError"], f"k={k} rank {r}"
    assert one_rank["mismatched"] == [None, None]


def test_rejected_requests_never_reach_a_follower(ranks):
    k, res = ranks
    before, after = res[0]["rejected"][0]
    assert after == before


def kill_scenario(tmp: str) -> dict:
    """Rank 1 dies on receiving its ``KILL_AFTER_OPS``-th descriptor;
    rank 0 submits distinct misses until one fails."""
    svc = GraphQueryService(_stream(), backend="sharded", max_batch=4, result_cache=False)
    if dist.get_rank() != 0:
        recv, seen = mesh_lib.recv_op, [0]

        def dying_recv():
            seen[0] += 1
            if seen[0] == KILL_AFTER_OPS:
                os._exit(7)
            return recv()

        mesh_lib.recv_op = dying_recv
        svc.start()
        return {}
    out = {"served": 0}
    svc.start()
    try:
        for i in range(64):
            t = svc.submit("bfs", source=i)
            t0 = time.perf_counter()
            try:
                t.result(timeout=KILL_FAIL_S)
                out["served"] += 1
            except TimeoutError:
                out["hung"] = True
                break
            except Exception as exc:  # noqa: BLE001 - the failure under test
                out["error"] = type(exc).__name__
                out["fail_s"] = time.perf_counter() - t0
                break
        with pytest.raises(RuntimeError):
            svc.submit("bfs", source=1)  # the service stopped taking requests
        out["stats"] = svc.stats()["ranks"]
    finally:
        t0 = time.perf_counter()
        svc.stop()
        out["stop_s"] = time.perf_counter() - t0
    return out


def test_killed_follower_fails_rank0_ticket(tmp_path):
    """A follower killed mid-run: rank 0's next ticket fails with an error
    within ``KILL_FAIL_S`` (never a hang), the service stops taking
    requests, and ``stop()`` returns."""
    ctx = multiprocessing.get_context("spawn")
    out = tmp_path / "out"
    out.mkdir()
    store = tmp_path / "store"
    procs = [ctx.Process(target=_run, args=(r, kill_scenario, 2, str(store), str(out),
                                            (str(tmp_path),)))
             for r in range(2)]
    for p in procs:
        p.start()
    deadline = time.time() + 120
    for p in procs:
        p.join(timeout=max(1, deadline - time.time()))
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
    assert not any(alive), "a rank hung"
    assert procs[1].exitcode == 7
    with open(out / "0.pkl", "rb") as f:
        res = pickle.load(f)
    assert "hung" not in res
    assert res["served"] >= 1 and res["error"] in (LaneFault.__name__, "RuntimeError",
                                                     "DistBackendError")
    assert res["fail_s"] < KILL_FAIL_S and res["stop_s"] < 30
    assert res["stats"]["lane_error"] is not None
