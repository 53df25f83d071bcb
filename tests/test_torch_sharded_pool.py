"""The port's range-sharded pool against the reference's, bit for bit.

The same numpy keys, batches and values go to ``repro.core.sharded_pool``
(on its one-device mesh) and to ``repro_torch.core.sharded_pool`` (on the
CPU, ``device="cpu"``); every leaf — ``data``, ``n``, ``lo``, ``vals``,
the ``shard_aux`` lanes, the compressed pools' streams — must be equal,
for n_shards in {1, 2, 4, 8}.  Counterparts of ``tests/test_sharded_pool.py``
and of the sharded roundtrip in ``tests/test_compressed.py``; the
collective-size test reads ``ShardedOps``' log instead of a jaxpr.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import sharded_pool as jsp
from repro_torch.core import compressed as tcz
from repro_torch.core import flat_ctree as tfct
from repro_torch.core import flat_graph as tfg
from repro_torch.core import sharded_pool as tsp
from repro_torch.core.traversal import sharded_backend as sb
from repro_torch.core.traversal import sharded_graph_of_flat
from repro_torch.data.rmat import rmat_edges, symmetrize

SHARDS = [1, 2, 4, 8]
_REF_STEPS = {}


def _ref_step(kind: str, S: int):
    """The reference's step for S shards, built once per module (each
    build is a fresh jit)."""
    key = (kind, S)
    if key not in _REF_STEPS:
        mesh = jsp.pool_mesh(S)
        make = {"insert": jsp.make_insert_step, "delete": jsp.make_delete_step,
                "insert_c": jsp.make_insert_step_compressed,
                "delete_c": jsp.make_delete_step_compressed}[kind]
        _REF_STEPS[key] = (mesh, make(mesh, ("shard",)))
    return _REF_STEPS[key]


def _port_step(kind: str, S: int):
    mesh = tsp.pool_mesh(S, "cpu")
    return {"insert": tsp.make_insert_step, "delete": tsp.make_delete_step,
            "insert_c": tsp.make_insert_step_compressed,
            "delete_c": tsp.make_delete_step_compressed}[kind](mesh)


def _padded(v, pad=None, fill=jsp.SENT, dtype=np.int64):
    pad = pad or int(2 ** np.ceil(np.log2(v.size + 1)))
    out = np.full(pad, fill, dtype)
    out[: v.size] = v
    return out


def _port_pool(ref: jsp.ShardedPool) -> tsp.ShardedPool:
    return tsp.from_state(np.asarray(ref.data), np.asarray(ref.n), np.asarray(ref.lo),
                          None if ref.vals is None else np.asarray(ref.vals), device="cpu")


def assert_leaves_equal(t, j, what=""):
    """Every leaf of a port NamedTuple equals the reference's: dtype,
    shape and bits (nested tuples recurse; None must match None)."""
    assert t._fields == j._fields, what
    for name, a, b in zip(t._fields, t, j):
        if isinstance(a, tuple):
            assert_leaves_equal(a, b, f"{what}.{name}")
            continue
        assert (a is None) == (b is None), f"{what}.{name}"
        if a is None:
            continue
        an, bn = a.cpu().numpy(), np.asarray(b)
        assert an.dtype == bn.dtype and an.shape == bn.shape, (f"{what}.{name}", an.dtype,
                                                              bn.dtype, an.shape, bn.shape)
        np.testing.assert_array_equal(an, bn, err_msg=f"{what}.{name}")


def _keys(seed, size, hi=1 << 30):
    return np.unique(np.random.default_rng(seed).integers(0, hi, size))


# ---------------------------------------------------------------------------
# build, roundtrip, membership
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", SHARDS)
def test_from_to_array_roundtrip(S):
    v = _keys(S, 700)
    t = tsp.from_array(v, n_shards=S, device="cpu")
    assert_leaves_equal(t, jsp.from_array(v, n_shards=S), "from_array")
    np.testing.assert_array_equal(tsp.to_array(t), v)
    lo = t.lo.numpy()
    assert (lo[1:] >= lo[:-1]).all()


@pytest.mark.parametrize("S", SHARDS)
def test_device_build_matches_host_build(S):
    """``sharded_graph_of_flat`` partitions a FlatGraph's pool on its
    device exactly as the host build does (and as the reference's)."""
    edges = symmetrize(rmat_edges(8, 1200, seed=S))
    w = (np.arange(edges.shape[0]) % 5 + 1).astype(np.float64)
    g = tfg.from_edges(256, edges, weights=w, device="cpu")
    sg = sharded_graph_of_flat(g, S)
    ref = jsp.graph_from_edges(256, tfg.to_edge_array(g), n_shards=S,
                               weights=tfg.to_weight_array(g))
    assert_leaves_equal(sg.pool, ref.pool, "sharded_graph_of_flat")
    assert sg.n == ref.n == 256
    np.testing.assert_array_equal(tsp.graph_to_edge_array(sg), tfg.to_edge_array(g))
    np.testing.assert_array_equal(tsp.graph_to_weight_array(sg), tfg.to_weight_array(g))
    assert tsp.graph_num_edges(sg) == int(g.m)


@pytest.mark.parametrize("S", [4, 8])
def test_member_queries_and_boundaries(S):
    rng = np.random.default_rng(5)
    v = np.unique(rng.integers(100, 1 << 16, 500))
    t = tsp.from_array(v, n_shards=S, device="cpu")
    q = np.concatenate([v[::13], [0, 1, int(v.min()) - 1, int(v.max()) + 1, 1 << 60],
                        t.lo.numpy()[1:], rng.integers(0, 1 << 17, 50)])
    got = tsp.member(t, q).numpy()
    np.testing.assert_array_equal(got, np.isin(q, v))
    np.testing.assert_array_equal(got, np.asarray(jsp.member(jsp.from_array(v, S),
                                                             jnp.asarray(q))))


@pytest.mark.parametrize("n_vals", [1, 2, 3, 7])
def test_empty_shard_lo_monotone(n_vals):
    v = np.arange(n_vals, dtype=np.int64) * 1000
    t = tsp.from_array(v, n_shards=8, device="cpu")
    assert_leaves_equal(t, jsp.from_array(v, n_shards=8), "sparse pool")
    lo = t.lo.numpy()
    assert (lo[1:] >= lo[:-1]).all() and lo[0] == np.iinfo(np.int64).min
    q = np.concatenate([v, v + 1])
    np.testing.assert_array_equal(tsp.member(t, q).numpy(), np.isin(q, v))


# ---------------------------------------------------------------------------
# the shard-local update steps
# ---------------------------------------------------------------------------


def _both_insert(S, va, vb, cap_per, wa=None, wb=None):
    ref_pool = jsp.from_array(va, S, cap_per=cap_per, vals=wa)
    batch = _padded(vb)
    bvals = None if wb is None else _padded(wb, batch.size, 0.0, np.float32)
    mesh, step = _ref_step("insert", S)
    with mesh:
        ref = step(ref_pool, jnp.asarray(batch), None if bvals is None else jnp.asarray(bvals))
    got = _port_step("insert", S)(_port_pool(ref_pool), torch.from_numpy(batch),
                                  None if bvals is None else torch.from_numpy(bvals))
    assert_leaves_equal(got, ref, f"insert S={S}")
    return got


@pytest.mark.parametrize("S", SHARDS)
def test_insert_step_matches_union(S):
    va, vb = _keys(10 + S, 300), _keys(20 + S, 120)
    got = _both_insert(S, va, vb, 512)
    np.testing.assert_array_equal(tsp.to_array(got), np.union1d(va, vb))


@pytest.mark.parametrize("S", [1, 2, 8])
def test_insert_then_rebalance_matches_union_merge(S):
    """Shard-local insert + rebalance == the flat rank-merge (the port's
    ``flat_ctree.union_merge``), and the rebalance equals the
    reference's."""
    va, vb = _keys(S, 800), _keys(100 + S, 300)
    cap_per = int(2 ** np.ceil(np.log2((va.size + vb.size) // S + vb.size + 1)))
    out = _both_insert(S, va, vb, cap_per)
    flat = tfct.union_merge(tfct.from_array(va, dtype=torch.int64, device="cpu"),
                            tfct.from_array(vb, dtype=torch.int64, device="cpu"),
                            tfct.grown_capacity(va.size + vb.size))
    np.testing.assert_array_equal(tsp.to_array(out), tfct.to_array(flat))
    reb = tsp.rebalance(out)
    assert_leaves_equal(reb, jsp.rebalance(jsp.ShardedPool(*(
        None if x is None else jnp.asarray(x.numpy()) for x in out))), "rebalance")
    counts = reb.n.numpy()
    assert counts.max() - counts.min() <= max(S - 1, 0)
    assert counts.max() == -(-counts.sum() // S)


def test_insert_boundary_key_into_sparse_pool_no_duplicate():
    got = _both_insert(8, np.asarray([0, 1000], np.int64), np.asarray([500, 1000], np.int64), 16)
    np.testing.assert_array_equal(tsp.to_array(got), [0, 500, 1000])


@pytest.mark.parametrize("S", [1, 4])
def test_insert_step_value_lane_overwrites(S):
    va = np.arange(0, 200, 2, dtype=np.int64)
    vb = np.arange(0, 100, 1, dtype=np.int64)
    got = _both_insert(S, va, vb, 512, np.full(va.size, 1.0, np.float32),
                       np.full(vb.size, 9.0, np.float32))
    ref = {int(k): 1.0 for k in va}
    ref.update({int(k): 9.0 for k in vb})  # the batch overwrites
    keys = tsp.to_array(got)
    np.testing.assert_array_equal(tsp.to_val_array(got), [ref[int(k)] for k in keys])


def test_insert_step_upgrades_unweighted_pool():
    """A weighted batch against a plain pool upgrades it to unit values."""
    va = np.arange(10, dtype=np.int64)
    pool = tsp.from_array(va, 2, cap_per=64, device="cpu")
    assert pool.vals is None
    batch = torch.from_numpy(_padded(np.asarray([100, 101], np.int64), 16))
    bvals = torch.from_numpy(_padded(np.asarray([5.0, 6.0], np.float32), 16, 0.0, np.float32))
    step = _port_step("insert", 2)
    out = step(pool, batch, bvals)
    out2 = step(tsp.with_unit_vals(pool), batch, bvals)
    assert_leaves_equal(out, out2, "upgrade")
    ref = {int(k): 1.0 for k in va}
    ref.update({100: 5.0, 101: 6.0})
    np.testing.assert_array_equal(tsp.to_val_array(out), [ref[int(k)] for k in tsp.to_array(out)])


@pytest.mark.parametrize("S", SHARDS)
def test_delete_step_matches_setdiff(S):
    rng = np.random.default_rng(3)
    v = np.unique(rng.integers(0, 1 << 20, 1200))
    w = (v % 11 + 1).astype(np.float32)
    dels = np.unique(np.concatenate([v[::3], rng.integers(1 << 21, 1 << 22, 40)]))
    ref_pool = jsp.from_array(v, S, vals=w)
    batch = _padded(dels)
    mesh, step = _ref_step("delete", S)
    with mesh:
        ref = step(ref_pool, jnp.asarray(batch))
    got = _port_step("delete", S)(_port_pool(ref_pool), torch.from_numpy(batch))
    assert_leaves_equal(got, ref, f"delete S={S}")
    np.testing.assert_array_equal(tsp.to_array(got), np.setdiff1d(v, dels))
    np.testing.assert_array_equal(tsp.to_val_array(got), w[~np.isin(v, dels)])
    np.testing.assert_array_equal(got.lo.numpy(), ref_pool.lo)  # boundaries untouched


def test_insert_step_collectives_batch_sized():
    """The update step never moves the pool: its only collective operand
    is the batch (the all-gather every shard receives)."""
    pool = tsp.from_array(_keys(0, 4000), 4, device="cpu")
    batch = torch.from_numpy(_padded(_keys(1, 200), 256))
    with sb.collective_log() as log:
        _port_step("insert", 4)(pool, batch)
        _port_step("delete", 4)(pool, batch)
    assert [name for name, _ in log] == ["all_gather", "all_gather"]
    assert all(nbytes <= batch.numel() * 8 for _, nbytes in log)


# ---------------------------------------------------------------------------
# value lane, rebalance policy
# ---------------------------------------------------------------------------


def test_value_lane_roundtrip_and_rebalance():
    v = _keys(2, 1000, 1 << 20)
    w = (v % 97 + 1).astype(np.float32)
    t = tsp.from_array(v, n_shards=4, vals=w, device="cpu")
    assert_leaves_equal(t, jsp.from_array(v, n_shards=4, vals=w), "vals")
    np.testing.assert_array_equal(tsp.to_val_array(t), w)
    r = tsp.rebalance(t)
    np.testing.assert_array_equal(tsp.to_array(r), v)
    np.testing.assert_array_equal(tsp.to_val_array(r), w)


@pytest.mark.parametrize("S", [1, 2, 8])
def test_rebalance_roundtrips_exactly(S):
    v = _keys(7, 3000, 1 << 40)
    t = tsp.from_array(v, n_shards=S, cap_per=4096, device="cpu")
    r = tsp.rebalance(t, cap_per=8192)
    assert_leaves_equal(r, jsp.rebalance(jsp.from_array(v, n_shards=S, cap_per=4096),
                                         cap_per=8192), "rebalance")
    np.testing.assert_array_equal(tsp.to_array(r), v)


def test_needs_rebalance_and_imbalance_stats():
    v = np.arange(100, dtype=np.int64)
    assert not tsp.needs_rebalance(tsp.from_array(v, 4, cap_per=32, device="cpu"))
    assert tsp.needs_rebalance(tsp.from_array(v, 4, cap_per=26, device="cpu"), slack=0.9)
    assert tsp.imbalance_stats(np.array([100, 100, 100, 100]))["imbalance"] == 1.0
    s = tsp.imbalance_stats(np.array([300, 100, 100, 100]))
    assert s == jsp.imbalance_stats(np.array([300, 100, 100, 100]))
    assert tsp.imbalance_stats(np.zeros(4, np.int64))["imbalance"] == 1.0
    assert tsp.imbalance_stats(np.array([], np.int64))["imbalance"] == 1.0


def _skewed(S=4, cap_per=8192):
    """An even pool, then an insert aimed at shard 0's key range."""
    rng = np.random.default_rng(4)
    even = np.unique(rng.integers(0, 1 << 20, 1000))
    p = tsp.from_array(even, n_shards=S, cap_per=cap_per, device="cpu")
    extra = np.unique(rng.integers(0, int(p.lo[1]), 4000))
    p2 = _port_step("insert", S)(p, torch.from_numpy(_padded(extra)))
    return p, p2, np.union1d(even, extra)


def test_should_and_maybe_rebalance():
    p, p2, all_keys = _skewed()
    assert not tsp.should_rebalance(p)
    assert tsp.imbalance_stats(p2)["imbalance"] > 2.0 and tsp.should_rebalance(p2)
    p3 = tsp.from_array(np.arange(100, dtype=np.int64), 4, cap_per=26, device="cpu")
    assert tsp.imbalance_stats(p3)["imbalance"] <= 2.0 and tsp.should_rebalance(p3)
    same, done = tsp.maybe_rebalance(p)
    assert not done and same is p
    r, done = tsp.maybe_rebalance(p2)
    assert done and tsp.imbalance_stats(r)["imbalance"] <= 1.5
    np.testing.assert_array_equal(tsp.to_array(r), all_keys)


def test_recommend_n_shards():
    for m in (0, 1 << 16, 10 * (1 << 16) + 1):
        assert tsp.recommend_n_shards(m) == jsp.recommend_n_shards(m)  # one device each
    assert tsp.recommend_n_shards(1 << 20, target_per_shard=1 << 10) == jsp.recommend_n_shards(
        1 << 20, target_per_shard=1 << 10) == 1024


# ---------------------------------------------------------------------------
# per-shard CSR aux and the compressed pool
# ---------------------------------------------------------------------------


def _graph(S, weighted, seed=11, log_n=8, draws=1500):
    edges = symmetrize(rmat_edges(log_n, draws, seed=seed))
    w = None
    if weighted:
        w = ((np.minimum(edges[:, 0], edges[:, 1]) * 7 + np.maximum(edges[:, 0], edges[:, 1]))
             % 5 + 1).astype(np.float64)
    return (tsp.graph_from_edges(1 << log_n, edges, n_shards=S, weights=w, device="cpu"),
            jsp.graph_from_edges(1 << log_n, edges, n_shards=S, weights=w))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("S", SHARDS)
def test_shard_aux_lanes(S, weighted):
    t, j = _graph(S, weighted)
    assert_leaves_equal(tsp.shard_aux(t.pool, t.n), jsp.shard_aux(j.pool, j.n), "shard_aux")


@pytest.mark.parametrize("layout", ["adaptive", 1, 2])
@pytest.mark.parametrize("S", SHARDS)
def test_compress_sharded_matches_reference(S, layout):
    t, j = _graph(S, weighted=True, seed=3)
    kw = {} if layout == "adaptive" else {"width": layout}
    if layout == 1:  # int8 lanes spill on this graph in both packages
        with pytest.raises(ValueError, match="spill"):
            jsp.compress_sharded(j, **kw)
        with pytest.raises(ValueError, match="spill"):
            tsp.compress_sharded(t, **kw)
        return
    ct, cj = tsp.compress_sharded(t, **kw), jsp.compress_sharded(j, **kw)
    assert_leaves_equal(ct.pool, cj.pool, f"compress_sharded {layout}")
    back = tsp.decompress_sharded(ct)
    assert_leaves_equal(back.pool, jsp.decompress_sharded(cj).pool, "decompress_sharded")
    cap = t.pool.cap_per
    np.testing.assert_array_equal(back.pool.data.numpy()[:, :cap], t.pool.data.numpy())
    np.testing.assert_array_equal(back.pool.vals.numpy()[:, :cap], t.pool.vals.numpy())
    assert tsp.should_rebalance(ct.pool) == tsp.should_rebalance(t.pool)


@pytest.mark.parametrize("layout", ["adaptive", 2])
def test_compress_sharded_rmat_2_11_matches_reference(layout):
    """rMAT 2^11 on 8 shard rows (tens of chunks a row; the adaptive
    lane's hi planes hold wide chunks in every row): ``shard_aux``,
    ``compress_sharded`` and ``decompress_sharded`` bit-identical to the
    reference's, and the round trip gives the raw lanes back."""
    t, j = _graph(8, weighted=True, seed=13, log_n=11, draws=12_000)
    assert int(t.pool.n.min()) > 4 * tcz.CHUNK
    assert_leaves_equal(tsp.shard_aux(t.pool, t.n), jsp.shard_aux(j.pool, j.n), "shard_aux")
    kw = {} if layout == "adaptive" else {"width": layout}
    ct, cj = tsp.compress_sharded(t, **kw), jsp.compress_sharded(j, **kw)
    assert_leaves_equal(ct.pool, cj.pool, f"compress_sharded {layout}")
    if layout == "adaptive":
        assert int(ct.pool.dst.wide.sum(1).min()) >= 2
    back = tsp.decompress_sharded(ct)
    assert_leaves_equal(back.pool, jsp.decompress_sharded(cj).pool, "decompress_sharded")
    cap = t.pool.cap_per
    np.testing.assert_array_equal(back.pool.data.numpy()[:, :cap], t.pool.data.numpy())
    np.testing.assert_array_equal(back.pool.vals.numpy()[:, :cap], t.pool.vals.numpy())


def _ref_compressed_step(kind, S, cpool, batch, n):
    """The reference's compressed step as its parts (decompress, the raw
    shard_map step, recompress, sticky spill): its fused jit does not run
    under JAX 0.9 (ROADMAP.md §3)."""
    mesh, step = _ref_step(kind, S)
    with mesh:
        raw = step(jsp.decompress_pool(cpool), jnp.asarray(batch))
    raw = jsp.ShardedPool(*(None if x is None else jnp.asarray(np.asarray(x)) for x in raw))
    hi_cap = cpool.dst.hi.shape[-2] if cpool.dst.hi is not None else None
    out = jsp.compress_pool(raw, n, cpool.dst.width, cpool.dst.k, hi_cap)
    return jsp._or_spill(out, cpool)


@pytest.mark.parametrize("S", [2, 8])
def test_compressed_steps_and_rebalance_match_reference(S):
    t, j = _graph(S, weighted=False, seed=5)
    ct, cj = tsp.compress_sharded(t, hi_headroom=1 / 16), jsp.compress_sharded(
        j, hi_headroom=1 / 16)
    assert_leaves_equal(ct.pool, cj.pool, "compress_sharded with headroom")
    ins = symmetrize(rmat_edges(8, 200, seed=9))
    batch = _padded(np.unique((ins[:, 0] << 32) | ins[:, 1]))
    rj = _ref_compressed_step("insert", S, cj.pool, batch, 256)
    rt = _port_step("insert_c", S)(ct.pool, torch.from_numpy(batch), None, n=256)
    assert_leaves_equal(rt, rj, "compressed insert")
    dels = np.sort(batch[::3])
    dj = _ref_compressed_step("delete", S, rj, dels, 256)
    dt = _port_step("delete_c", S)(rt, torch.from_numpy(dels), n=256)
    assert_leaves_equal(dt, dj, "compressed delete")
    assert_leaves_equal(tsp.rebalance_compressed(dt, 256, cap_per=2 * dt.cap_per),
                        jsp.rebalance_compressed(dj, 256, cap_per=2 * int(dj.cap_per)),
                        "rebalance_compressed")
    assert tsp.needs_rebalance_compressed(dt) == jsp.needs_rebalance_compressed(dj)


def test_compressed_steps_rmat_2_11_match_reference():
    """The compressed insert and delete steps at rMAT 2^11 on 8 shard rows,
    against the reference's parts, bit for bit."""
    n = 1 << 11
    t, j = _graph(8, weighted=False, seed=15, log_n=11, draws=12_000)
    ct, cj = tsp.compress_sharded(t, hi_headroom=1 / 16), jsp.compress_sharded(
        j, hi_headroom=1 / 16)
    ins = symmetrize(rmat_edges(11, 1500, seed=19))
    batch = _padded(np.unique((ins[:, 0] << 32) | ins[:, 1]))
    rj = _ref_compressed_step("insert", 8, cj.pool, batch, n)
    rt = _port_step("insert_c", 8)(ct.pool, torch.from_numpy(batch), None, n=n)
    assert_leaves_equal(rt, rj, "compressed insert")
    dels = np.sort(batch[::3])
    dj = _ref_compressed_step("delete", 8, rj, dels, n)
    dt = _port_step("delete_c", 8)(rt, torch.from_numpy(dels), n=n)
    assert_leaves_equal(dt, dj, "compressed delete")


@pytest.mark.parametrize("adaptive", [False, True])
def test_batched_codec_matches_per_row(adaptive):
    """``encode_rows`` equals one ``encode_stream`` per row, and one
    ``decode_rows_batched`` call (flattened rows, joined hi plane) equals
    the per-row decodes, for rows shorter and longer than a chunk."""
    rng = np.random.default_rng(2)
    for L in (40, 3 * tcz.CHUNK + 17):
        steps = rng.integers(0, 100, (5, L))
        steps[2, L // 2:] = rng.integers(200, 3000, L - L // 2)  # wide chunks in one row
        steps[4, L // 3] = 70_000  # one escape
        rows = np.cumsum(steps, axis=1).astype(np.int32)
        vals = torch.from_numpy(rows)
        if adaptive:
            b = tcz.encode_rows_adaptive(vals, hi_cap=4)
            per = [tcz.encode_stream_adaptive(vals[s], hi_cap=4) for s in range(5)]
            assert not bool(b.spill.any()) and int(b.wide.sum()) > 0
        else:
            b = tcz.encode_rows(vals, width=2)
            per = [tcz.encode_stream(vals[s], width=2) for s in range(5)]
        for s, c in enumerate(per):
            assert_leaves_equal(tcz.ChunkedStream(*(None if x is None else x[s] for x in b)), c)
        dec = tcz.decode_rows_batched(b)
        for s, c in enumerate(per):
            np.testing.assert_array_equal(dec[s].numpy(), tcz.decode_stream(c).numpy())
            np.testing.assert_array_equal(dec[s, :L].numpy(), rows[s])
