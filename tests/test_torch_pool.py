"""The port's device pool against the JAX reference, bit for bit.

Same numpy inputs into ``repro.core.flat_ctree`` / ``flat_graph`` and
their ``repro_torch`` counterparts (on the CPU): keys, valid counts,
offsets and value lanes must be identical.  Capacities are fixed so the
reference compiles each function once.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import flat_ctree as jfct
from repro.core import flat_graph as jfg
from repro.core.hash import hash32_np as ref_hash32_np
from repro_torch.core import flat_ctree as tfct
from repro_torch.core import flat_graph as tfg
from repro_torch.core.hash import hash32_np, hash32_torch, is_head_np, is_head_torch

from proptest import given, st

CAP = 256  # pool capacity
BCAP = 64  # batch capacity
N = 40  # vertices of the graph tests


def keys64(max_size):
    return st.lists(st.integers(min_value=0, max_value=(1 << 40)), min_size=0, max_size=max_size)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _same_pool(got: tfct.FlatCTree, want: jfct.FlatCTree):
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert int(got.n) == int(want.n)
    assert (got.vals is None) == (want.vals is None)
    if got.vals is not None:
        np.testing.assert_array_equal(got.vals.numpy(), np.asarray(want.vals))


def _batch_pair(xs, ws, cap):
    """The same raw (unsorted, duplicated, sentinel-padded) batch built by
    both packages' ``from_device``."""
    raw = np.full(cap, jfct.SENTINEL64, np.int64)
    raw[: len(xs)] = xs
    vals = None
    if ws is not None:
        vals = np.zeros(cap, np.float32)
        vals[: len(xs)] = ws[: len(xs)]
    j = jfct.from_device(jnp.asarray(raw), cap, None if vals is None else jnp.asarray(vals))
    t = tfct.from_device(_t(raw), cap, None if vals is None else _t(vals))
    return t, j


def _weights(rng, k):
    return rng.integers(1, 9, size=k).astype(np.float32)


@given(st.lists(st.integers(min_value=-(2**62), max_value=2**62), max_size=300))
def test_hash_bit_identical(xs):
    x = np.asarray(xs, np.int64)
    want = ref_hash32_np(x)
    np.testing.assert_array_equal(hash32_np(x), want)
    np.testing.assert_array_equal(hash32_torch(_t(x)).numpy(), want.astype(np.int64))
    for b in (64, 100, 256):
        np.testing.assert_array_equal(is_head_torch(_t(x), b).numpy(), is_head_np(x, b))


@given(keys64(BCAP), st.booleans(), st.integers(min_value=0, max_value=2**31))
def test_from_device_bit_identical(xs, weighted, seed):
    ws = _weights(np.random.default_rng(seed), BCAP) if weighted else None
    t, j = _batch_pair(xs, ws, BCAP)
    _same_pool(t, j)


@given(keys64(CAP // 2), keys64(BCAP), st.booleans(), st.booleans(),
       st.integers(min_value=0, max_value=2**31))
def test_union_bit_identical(a, b, merge, weighted, seed):
    rng = np.random.default_rng(seed)
    ta, ja = _batch_pair(a, _weights(rng, CAP) if weighted else None, CAP)
    tb, jb = _batch_pair(b, _weights(rng, BCAP) if weighted else None, BCAP)
    tfn, jfn = (tfct.union_merge, jfct.union_merge) if merge else (tfct.union_sort,
                                                                      jfct.union_sort)
    _same_pool(tfn(ta, tb, CAP), jfn(ja, jb, CAP))


@given(keys64(CAP // 2), keys64(BCAP), st.booleans())
def test_difference_and_member_bit_identical(a, b, weighted):
    rng = np.random.default_rng(len(a))
    ta, ja = _batch_pair(a, _weights(rng, CAP) if weighted else None, CAP)
    tb, jb = _batch_pair(list(b) + list(a[: len(a) // 3]), None, BCAP * 2)
    _same_pool(tfct.difference(ta, tb, CAP), jfct.difference(ja, jb, CAP))
    _same_pool(tfct.intersect(ta, tb, CAP), jfct.intersect(ja, jb, CAP))
    q = np.asarray(list(a[:20]) + list(b[:20]) + [jfct.SENTINEL64], np.int64)
    np.testing.assert_array_equal(tfct.member(ta, _t(q)).numpy(),
                                  np.asarray(jfct.member(ja, jnp.asarray(q))))


def _edges(rng, k, n=N):
    return rng.integers(0, n, size=(k, 2)).astype(np.int64)


def _same_graph(got: tfg.FlatGraph, want: jfg.FlatGraph):
    np.testing.assert_array_equal(got.offsets.numpy(), np.asarray(want.offsets))
    np.testing.assert_array_equal(got.keys.numpy(), np.asarray(want.keys))
    assert int(got.m) == int(want.m)
    assert (got.weights is None) == (want.weights is None)
    if got.weights is not None:
        np.testing.assert_array_equal(got.weights.numpy(), np.asarray(want.weights))


@given(st.integers(min_value=0, max_value=2**31), st.booleans(), st.booleans())
def test_graph_updates_bit_identical(seed, weighted, grow):
    """insert/delete_edges_device over one stream of batches, including a
    weight upgrade and vertex growth."""
    rng = np.random.default_rng(seed)
    e0 = _edges(rng, 60)
    w0 = _weights(rng, 60) if weighted else None
    tg = tfg.from_edges(N, e0, edge_capacity=CAP, weights=w0, device="cpu")
    jg = jfg.from_edges(N, e0, edge_capacity=CAP, weights=w0)
    _same_graph(tg, jg)
    for step in range(3):
        ins = _edges(rng, 30, n=N + (8 if grow and step == 2 else 0))
        wins = _weights(rng, BCAP) if (weighted or step == 1) else None
        if wins is not None and tg.weights is None:
            tg, jg = tfg.with_unit_weights(tg), jfg.with_unit_weights(jg)
        tb, jb = _batch_pair(list((ins[:, 0] << 32) | ins[:, 1]), wins, BCAP)
        n_out = max(tg.n, int(ins[:, 0].max()) + 1)
        n_out = None if n_out == tg.n else n_out
        tg = tfg.insert_edges_device(tg, tb, CAP, n_out=n_out)
        jg = jfg.insert_edges_device(jg, jb, CAP, n_out=n_out)
        _same_graph(tg, jg)
        dels = np.concatenate([_edges(rng, 10), jfg.to_edge_array(jg)[::7]])
        tb, jb = _batch_pair(list((dels[:, 0] << 32) | dels[:, 1]), None, BCAP)
        tg, jg = tfg.delete_edges_device(tg, tb), jfg.delete_edges_device(jg, jb)
        _same_graph(tg, jg)


def test_host_entry_points_match_reference():
    rng = np.random.default_rng(5)
    e0, e1, e2 = _edges(rng, 80), _edges(rng, 25), _edges(rng, 15)
    w1 = rng.random(25)
    tg = tfg.from_edges(N, e0, device="cpu")
    jg = jfg.from_edges(N, e0)
    _same_graph(tg, jg)
    tg, jg = tfg.insert_edges_host(tg, e1, weights=w1), jfg.insert_edges_host(jg, e1, weights=w1)
    _same_graph(tg, jg)
    tg, jg = tfg.delete_edges_host(tg, e2), jfg.delete_edges_host(jg, e2)
    _same_graph(tg, jg)
    np.testing.assert_array_equal(tfg.to_edge_array(tg), jfg.to_edge_array(jg))
    np.testing.assert_array_equal(tfg.to_weight_array(tg), jfg.to_weight_array(jg))
    np.testing.assert_array_equal(tfg.degrees(tg).numpy(), np.asarray(jfg.degrees(jg)))
    q = _edges(rng, 50)
    np.testing.assert_array_equal(
        tfg.has_edge(tg, _t(q[:, 0]), _t(q[:, 1])).numpy(),
        np.asarray(jfg.has_edge(jg, jnp.asarray(q[:, 0]), jnp.asarray(q[:, 1]))))


@pytest.mark.parametrize("weighted", [False, True])
def test_from_state_round_trips(weighted):
    rng = np.random.default_rng(11)
    e = _edges(rng, 70)
    jg = jfg.from_edges(N, e, weights=rng.random(70) if weighted else None)
    tg = tfg.from_state(np.asarray(jg.offsets), np.asarray(jg.keys), int(jg.m),
                        None if jg.weights is None else np.asarray(jg.weights), device="cpu")
    _same_graph(tg, jg)
    jt = jfct.from_array(rng.integers(0, 1000, 50), vals=rng.random(50) if weighted else None)
    tt = tfct.from_state(np.asarray(jt.data), int(jt.n),
                         None if jt.vals is None else np.asarray(jt.vals), device="cpu")
    _same_pool(tt, jt)
    np.testing.assert_array_equal(tfct.to_array(tt), jfct.to_array(jt))


def test_grown_capacity_and_heads_match():
    for k in (0, 1, 7, 8, 9, 1000, 4097):
        assert tfct.grown_capacity(k) == jfct.grown_capacity(k)
    jt = jfct.from_array(np.arange(0, 5000, 3), dtype=jnp.int32)
    tt = tfct.from_state(np.asarray(jt.data), int(jt.n), device="cpu")
    np.testing.assert_array_equal(tfct.head_mask(tt, 16, 7).numpy(),
                                  np.asarray(jfct.head_mask(jt, 16, 7)))
    assert tfct.num_heads(tt, 16, 7) == jfct.num_heads(jt, 16, 7)


# ---------------------------------------------------------------------------
# the host-driven set API (tests/test_flat_ctree.py:75-86's reference)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("optimized", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_multi_insert_delete_host_api_matches_reference(optimized, weighted):
    rng = np.random.default_rng(0)
    base_in = rng.integers(0, 1 << 20, 1000).astype(np.int32)
    base_w = rng.random(1000).astype(np.float32) if weighted else None
    tt = tfct.from_array(base_in, vals=base_w, device="cpu")
    jt = jfct.from_array(base_in, vals=base_w)
    _same_pool(tt, jt)
    base = tfct.to_array(tt).copy()
    batch = rng.integers(0, 1 << 20, 500).astype(np.int32)
    bw = rng.random(500).astype(np.float32) if weighted else None
    t2 = tfct.multi_insert(tt, batch, optimized=optimized, vals=bw)
    _same_pool(t2, jfct.multi_insert(jt, batch, optimized=optimized, vals=bw))
    np.testing.assert_array_equal(tfct.to_array(t2), np.union1d(base, batch))
    t3 = tfct.multi_delete(t2, batch)
    _same_pool(t3, jfct.multi_delete(jfct.multi_insert(jt, batch, optimized=optimized, vals=bw),
                                      batch))
    np.testing.assert_array_equal(tfct.to_array(t3), np.setdiff1d(np.union1d(base, batch), batch))
    # persistence: the pool a call was given is left as it was
    np.testing.assert_array_equal(tfct.to_array(tt), base)
    _same_pool(tt, jt)


def test_multi_insert_grows_capacity_like_the_reference():
    jt, tt = jfct.from_array(np.arange(6), cap=8), tfct.from_array(np.arange(6), cap=8,
                                                                   device="cpu")
    grown = tfct.multi_insert(tt, np.arange(100, 130))
    _same_pool(grown, jfct.multi_insert(jt, np.arange(100, 130)))
    assert tfct.capacity(grown) == jfct.capacity(jfct.multi_insert(jt, np.arange(100, 130))) == 64


@pytest.mark.parametrize("dtype", ["int32", "int64"])
def test_empty_find_and_chunk_ids_match_reference(dtype):
    j = jfct.empty(16, dtype=getattr(jnp, dtype))
    t = tfct.empty(16, dtype=getattr(torch, dtype), device="cpu")
    _same_pool(t, j)
    assert not tfct.find(t, 3) and not jfct.find(j, 3)
    v = np.unique(np.random.default_rng(1).integers(0, 1 << 20, 3000))
    j = jfct.from_array(v, dtype=getattr(jnp, dtype))
    t = tfct.from_array(v, dtype=getattr(torch, dtype), device="cpu")
    for e in (int(v[0]), int(v[-1]), int(v[7]) + 1, -1, 1 << 21):
        assert tfct.find(t, e) == jfct.find(j, e)
    for b, seed in ((16, 7), (64, 0x9E3779B9), (100, 3)):
        got = tfct.chunk_ids(t, b, seed)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jfct.chunk_ids(j, b, seed)))


def test_edge_endpoints_and_priority_np_match_reference():
    from repro.core.hash import priority_np as ref_priority_np
    from repro_torch.core.hash import priority_np

    rng = np.random.default_rng(9)
    e = _edges(rng, 70)
    jg, tg = jfg.from_edges(N, e), tfg.from_edges(N, e, device="cpu")
    for got, want in zip(tfg.edge_endpoints(tg), jfg.edge_endpoints(jg)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))  # pad slots included
    x = rng.integers(-(2**40), 2**40, 500)
    for seed in (0, 7, int(np.uint32(0x9E3779B9))):
        np.testing.assert_array_equal(priority_np(x, seed), ref_priority_np(x, seed))
    np.testing.assert_array_equal(priority_np(x), ref_priority_np(x))
