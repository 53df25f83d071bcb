"""The port's compressed layout against the JAX reference.

Codec, pool, engine and stream, all on the CPU at n <= 1024, inputs from
numpy seeds.  Bit-identical: every leaf of the encoders (fixed width 1
and 2, adaptive; the ``spill`` flag included), of ``compress_host`` and
the compressed insert / delete, of ``engine_aux_compressed``, the
decompressed pools, ``chunk_stats``, and the integer-state queries of
``CompressedEngine`` against the reference's flat ``CompressedEngine``
(BFS, CC, SSSP on integer weights).  PageRank (5 iterations, the
reference's chunked reduce in interpret mode) within rtol 1e-6,
atol 1e-7; BC within rtol 1e-6 of the port's raw engine (the same
kernels in the same order) and rtol 1e-4 of the reference (whose BC
rounds sum by float cumsum differences, ROADMAP.md §3).  The port raises
``ValueError`` wherever the reference's layout spills.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressed as jcz
from repro.core import flat_graph as jfg
from repro.core import graph as jG
from repro.core.streaming import AspenStream as JaxStream
from repro.core.traversal import algorithms as jalg
from repro.core.traversal import make_engine as j_make_engine
from repro_torch.core import compressed as tcz
from repro_torch.core import flat_graph as tfg
from repro_torch.core import graph as tG
from repro_torch.core import streaming as tst
from repro_torch.core.traversal import CompressedEngine, TorchEngine, flat_graph_of, make_engine
from repro_torch.core.traversal import algorithms as talg
from repro_torch.core.traversal import torch_backend as tb
from repro_torch.data.rmat import rmat_communities, rmat_edges, symmetrize

CHUNK = tcz.CHUNK
K = tcz.OVF_SLOTS


def assert_leaves_equal(t, j, what=""):
    """Every leaf of a port NamedTuple equals the reference's, dtype,
    shape and bits (nested streams recurse; None must match None)."""
    assert t._fields == j._fields
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


def leaves(x):
    """The reference's leaves as numpy arrays, in field order."""
    return [None if v is None else np.asarray(v) for v in x]


def _weights_for(edges):
    lo = np.minimum(edges[:, 0], edges[:, 1])
    hi = np.maximum(edges[:, 0], edges[:, 1])
    return ((lo * 1000003 + hi) % 7 + 1).astype(np.float64)  # symmetric, integer


def _lane(L, profile, seed):
    """int32[L] lanes of a given delta profile (signed deltas)."""
    rng = np.random.default_rng(seed)
    if profile == "int8":
        d = rng.integers(-60, 60, L)
    elif profile == "int16":
        d = rng.integers(-16_000, 16_000, L)
    elif profile == "escapes":  # <= k escapes past int16 per chunk
        d = rng.integers(-100, 100, L)
        for r in range(-(-L // CHUNK)):
            cols = r * CHUNK + rng.choice(np.arange(1, CHUNK), K, replace=False)
            cols = cols[cols < L]
            d[cols] = rng.integers(40_000, 1 << 20, cols.size) * rng.choice([-1, 1], cols.size)
    else:  # "spill": every delta escapes
        d = np.full(L, 40_000)
    return np.cumsum(d).astype(np.int32)


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("profile", ["int8", "int16", "escapes", "spill"])
@pytest.mark.parametrize("L", [1, 100, CHUNK, 3 * CHUNK + 17])
def test_fixed_codec_bit_identical(width, profile, L):
    vals = _lane(L, profile, seed=L + width)
    t = tcz.encode_stream(torch.from_numpy(vals), width=width)
    j = jcz.encode_stream(jnp.asarray(vals), width=width)
    assert_leaves_equal(t, j)
    assert t.width == width and t.k == K and not t.adaptive and t.hi_cap == 0
    np.testing.assert_array_equal(tcz.decode_rows(t).numpy(), np.asarray(jcz.decode_rows(j)))
    if not bool(t.spill):
        np.testing.assert_array_equal(tcz.decode_stream(t, length=L).numpy(), vals)


def _mixed_lane(R, seed):
    """Narrow chunks, narrow chunks with int8 escapes, wide chunks, wide
    chunks with int16 escapes (the reference's mixed-width test, grown)."""
    rng = np.random.default_rng(seed)
    d = rng.integers(-100, 100, (R, CHUNK))
    for r in range(R):
        cols = rng.permutation(np.arange(1, CHUNK))
        if r % 4 == 1:
            d[r, cols[:K]] = rng.integers(128, 5000, K)
        if r % 4 >= 2:
            d[r, cols[:20]] = rng.integers(200, 30_000, 20) * rng.choice([-1, 1], 20)
        if r % 4 == 3:
            d[r, cols[20:20 + 1 + r % K]] = rng.integers(40_000, 1 << 20, 1 + r % K)
    return np.cumsum(d.reshape(-1)).astype(np.int32)


@pytest.mark.parametrize("case", ["headroom", "exact", "narrow_h0", "hi_overflow", "esc_spill"])
def test_adaptive_codec_bit_identical(case):
    R = 9
    vals = _mixed_lane(R, seed=3)[: R * CHUNK - 11]
    if case == "narrow_h0":
        vals = _lane(R * CHUNK - 11, "int8", seed=4)
    if case == "esc_spill":
        vals = _lane(R * CHUNK - 11, "spill", seed=4)
    n_wide = int(jcz.encode_stream_adaptive(jnp.asarray(vals), hi_cap=R).wide.sum())
    hi_cap = {"headroom": n_wide + 3, "exact": n_wide, "narrow_h0": 0,
              "hi_overflow": max(n_wide - 2, 0), "esc_spill": R}[case]
    t = tcz.encode_stream_adaptive(torch.from_numpy(vals), hi_cap=hi_cap)
    j = jcz.encode_stream_adaptive(jnp.asarray(vals), hi_cap=hi_cap)
    assert_leaves_equal(t, j)
    assert t.adaptive and t.hi_cap == hi_cap
    assert bool(t.spill) == (case in ("hi_overflow", "esc_spill"))
    if case == "headroom":
        assert n_wide >= 2 and int((t.ovf_pos < CHUNK).sum()) > 0
        assert bool(t.wide[2]) and not bool(t.wide[0])
    np.testing.assert_array_equal(tcz.adaptive_deltas(t).numpy(),
                                  np.asarray(jcz.adaptive_deltas(j)))
    np.testing.assert_array_equal(tcz.decode_rows(t).numpy(), np.asarray(jcz.decode_rows(j)))
    if not bool(t.spill):
        np.testing.assert_array_equal(tcz.decode_stream(t, vals.size).numpy(), vals)
    assert tcz.stream_nbytes(t) == jcz.stream_nbytes(j)


def test_stream_from_state_round_trips():
    j = jcz.encode_stream_adaptive(jnp.asarray(_mixed_lane(5, seed=8)), hi_cap=4)
    assert_leaves_equal(tcz.from_state(*leaves(j), device="cpu"), j)
    j2 = jcz.encode_stream(jnp.asarray(_lane(300, "escapes", seed=8)), width=2)
    assert_leaves_equal(tcz.from_state(*leaves(j2), device="cpu"), j2)


# ---------------------------------------------------------------------------
# compressed pool
# ---------------------------------------------------------------------------


def _pools(log_n=8, draws=2000, seed=11, weighted=False):
    n = 1 << log_n
    edges = symmetrize(rmat_edges(log_n, draws, seed=seed))
    w = _weights_for(edges) if weighted else None
    jg = jfg.from_edges(n, edges, weights=w)
    tg = tfg.from_state(np.asarray(jg.offsets), np.asarray(jg.keys), int(jg.m),
                        None if jg.weights is None else np.asarray(jg.weights), device="cpu")
    return n, edges, w, jg, tg


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kw", [{}, {"width": 2}, {"width": 1}, {"hi_headroom": 1 / 16},
                                {"hi_headroom": 1.0}])
def test_compress_host_bit_identical(kw, weighted):
    n, _, _, jg, tg = _pools(weighted=weighted)
    try:
        jc = jfg.compress_host(jg, **kw)
    except ValueError:
        with pytest.raises(ValueError, match="escape"):
            tfg.compress_host(tg, **kw)
        return
    tc = tfg.compress_host(tg, **kw)
    assert_leaves_equal(tc, jc)
    assert tc.n == n and tc.edge_capacity == jc.edge_capacity
    back = tfg.decompress(tc)
    jback = jfg.decompress(jc)
    assert_leaves_equal(back, jback)
    np.testing.assert_array_equal(back.keys.numpy()[: int(tg.m)], tg.keys.numpy()[: int(tg.m)])
    assert bool((back.keys[int(tg.m):] == tfg.SENT64).all())
    assert_leaves_equal(tfg.compressed_from_state(
        np.asarray(jc.offsets), leaves(jc.dst), int(jc.m),
        None if jc.weights is None else np.asarray(jc.weights), device="cpu"), jc)


def test_spilled_graph_raises_as_reference():
    """The reference's spilling input: one src, 10 consecutive gaps just
    past the int16 limit in one chunk.  Both checked builds raise; a pool built
    without the check carries the flag, and an engine over it raises."""
    dsts = np.arange(K + 2, dtype=np.int64) * 32_768
    edges = np.stack([np.zeros_like(dsts), dsts], axis=1)
    n = int(dsts.max()) + 1
    jg = jfg.from_edges(n, edges)
    tg = tfg.from_edges(n, edges, device="cpu")
    for kw in ({}, {"width": 2}, {"width": 1}):
        with pytest.raises(ValueError, match="escape"):
            jfg.compress_host(jg, **kw)
        with pytest.raises(ValueError, match="escape"):
            tfg.compress_host(tg, **kw)
    cg = tfg.compress(tg, width=2)
    assert bool(cg.dst.spill) and bool(jfg.compress(jg, width=2).dst.spill)
    with pytest.raises(ValueError, match="spill"):
        make_engine(cg)



@pytest.mark.parametrize("log_c,count", [(6, 5), (8, 3)])
def test_rmat_communities_compress_as_reference(log_c, count):
    """Community c is the reference generator's graph at seed ``seed + c``,
    numbered from ``c << log_c``; no edge crosses communities, and both
    packages compress the graph to the same leaves."""
    from repro.data.rmat import rmat_edges as j_rmat_edges
    from repro.data.rmat import symmetrize as j_symmetrize

    edges = rmat_communities(log_c, count, 4, seed=7)
    want = np.concatenate([j_symmetrize(j_rmat_edges(log_c, 4 << log_c, seed=7 + c)) + (c << log_c)
                           for c in range(count)])
    np.testing.assert_array_equal(edges, want)
    np.testing.assert_array_equal(edges[:, 0] >> log_c, edges[:, 1] >> log_c)
    n = count << log_c
    jc = jfg.compress_host(jfg.from_edges(n, edges))
    tc = tfg.compress_host(tfg.from_edges(n, edges, device="cpu"))
    assert_leaves_equal(tc, jc)
    assert not bool(tc.dst.spill)

@pytest.mark.parametrize("seed,log_n,m", [(11, 8, 2000), (23, 9, 4000), (5, 10, 9000)])
def test_chunk_stats_and_resident_bytes(seed, log_n, m):
    """``chunk_stats`` equals the reference's, and the adaptive pool's
    resident bytes equal ``bytes_ideal`` exactly."""
    _, _, _, jg, tg = _pools(log_n, m, seed)
    got, want = tfg.chunk_stats(tg), jfg.chunk_stats(jg)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    cg = tfg.compress_host(tg)
    assert tcz.stream_nbytes(cg.dst) == got["bytes_ideal"]
    assert tcz.stream_nbytes(cg.dst) <= tcz.stream_nbytes(tfg.compress_host(tg, width=2).dst)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kw", [{"hi_headroom": 1.0}, {}, {"width": 2}])
def test_insert_delete_compressed_bit_identical(kw, weighted):
    """Decompress, rank-merge, recompress: every leaf equal to the
    reference's, widths and hi capacity inherited, the spill flag ORed
    (an exact-fit hi plane overflows on this insert: both flag it)."""
    n, edges, w, jg_full, _ = _pools(weighted=weighted)
    half = len(edges) // 2
    cap = jg_full.edge_capacity
    wk = {} if w is None else {"weights": w[:half]}
    jg = jfg.from_edges(n, edges[:half], edge_capacity=cap, **wk)
    tg = tfg.from_state(np.asarray(jg.offsets), np.asarray(jg.keys), int(jg.m),
                        None if jg.weights is None else np.asarray(jg.weights), device="cpu")
    jc, tc = jfg.compress_host(jg, **kw), tfg.compress_host(tg, **kw)
    bw = None if w is None else w[half:]
    jc2 = jfg.insert_edges_compressed(jc, jfg.batch_from_edges(edges[half:], weights=bw), cap)
    tc2 = tfg.insert_edges_compressed(
        tc, tfg.batch_from_edges(edges[half:], weights=bw, device="cpu"), cap)
    assert_leaves_equal(tc2, jc2, "insert")
    assert tc2.dst.hi_cap == tc.dst.hi_cap
    jc3 = jfg.delete_edges_compressed(jc2, jfg.batch_from_edges(edges[:100]), cap)
    tc3 = tfg.delete_edges_compressed(tc2, tfg.batch_from_edges(edges[:100], device="cpu"), cap)
    assert_leaves_equal(tc3, jc3, "delete")
    if kw == {}:  # the exact-fit plane overflowed, and the flag stays set
        assert bool(tc2.dst.spill) and bool(tc3.dst.spill)
    if kw == {"hi_headroom": 1.0}:
        assert not bool(tc3.dst.spill)
        np.testing.assert_array_equal(tfg.to_edge_array(tfg.decompress(tc3)),
                                      jfg.to_edge_array(jfg.decompress(jc3)))
    wc = tfg.with_unit_weights_compressed(tc)
    assert wc.weights is not None and wc.weights.shape[0] == tc.edge_capacity


# ---------------------------------------------------------------------------
# compressed engine
# ---------------------------------------------------------------------------


def _engines(weighted: bool, **kw):
    n, edges, w, jg, tg = _pools(weighted=weighted)
    jc = jfg.compress_host(jg, **kw)
    tc = tfg.compress_host(tg, **kw)
    return n, edges, make_engine(tc), j_make_engine(jc), TorchEngine(tg)


@pytest.fixture(scope="module")
def plain():
    return _engines(weighted=False)


@pytest.fixture(scope="module")
def weighted():
    return _engines(weighted=True)


@pytest.fixture(scope="module")
def fixed2():
    return _engines(weighted=True, width=2)


@pytest.mark.parametrize("which", ["plain", "weighted", "fixed2"])
def test_engine_aux_compressed_bit_identical(which, request):
    _, _, te, je, _ = request.getfixturevalue(which)
    assert isinstance(te, CompressedEngine)
    assert_leaves_equal(te.caux, je.caux)
    assert te.resident_nbytes == je.resident_nbytes
    rebuilt = tb.compressed_aux_from_state(
        leaves(je.caux.dst_sorted_c), leaves(je.caux.srcbd_c), np.asarray(je.caux.dst_offsets),
        np.asarray(je.caux.degrees), int(je.caux.m_valid),
        None if je.caux.w_by_dst is None else np.asarray(je.caux.w_by_dst), device="cpu")
    assert_leaves_equal(rebuilt, je.caux)


SOURCES = [0, 1, 5, 77, 200]


@pytest.mark.parametrize("which", ["plain", "weighted", "fixed2"])
def test_compressed_engine_integer_queries_bit_identical(which, request):
    _, edges, te, je, raw = request.getfixturevalue(which)
    src = int(edges[0, 0])
    np.testing.assert_array_equal(talg.bfs(te, src), jalg.bfs(je, src))
    parents = talg.bfs_multi(te, SOURCES)[0]
    np.testing.assert_array_equal(parents, jalg.bfs_multi(je, SOURCES)[0])
    np.testing.assert_array_equal(parents, talg.bfs_multi(raw, SOURCES)[0])
    np.testing.assert_array_equal(talg.connected_components(te),
                                  jalg.connected_components(je))
    np.testing.assert_array_equal(np.asarray(talg.sssp(te, src)), np.asarray(jalg.sssp(je, src)))
    np.testing.assert_array_equal(talg.sssp_multi(te, SOURCES), jalg.sssp_multi(je, SOURCES))
    depths = talg.landmark_distances(te, SOURCES)
    np.testing.assert_array_equal(te.parents_from_depths(depths).numpy(),
                                  np.asarray(je.parents_from_depths(depths)))


@pytest.mark.parametrize("which", ["plain", "weighted", "fixed2"])
def test_compressed_engine_pagerank_and_bc(which, request):
    n, _, te, je, raw = request.getfixturevalue(which)
    np.testing.assert_allclose(talg.pagerank(te, iters=5), jalg.pagerank(je, iters=5),
                               rtol=1e-6, atol=1e-7)
    resets = np.random.default_rng(2).random((3, n))
    resets /= resets.sum(1, keepdims=True)
    np.testing.assert_allclose(talg.pagerank_multi(te, resets, iters=5),
                               jalg.pagerank_multi(je, resets, iters=5), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(te.weighted_degrees.numpy(), np.asarray(je.weighted_degrees),
                               rtol=1e-6)
    bc = talg.bc_multi(te, SOURCES[:3])
    np.testing.assert_allclose(bc, talg.bc_multi(raw, SOURCES[:3]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(bc, jalg.bc_multi(je, SOURCES[:3]), rtol=1e-4, atol=1e-4)


def test_make_engine_dispatches_compressed_pool(plain):
    _, _, te, _, _ = plain
    assert isinstance(make_engine(te.cg), CompressedEngine)
    assert isinstance(make_engine(te.cg, backend="torch"), CompressedEngine)
    with pytest.raises(TypeError):
        make_engine(te.cg, backend="numpy")
    assert te.n == te.cg.n and te.m == int(te.cg.m)


def test_aux_lanes_retry_at_full_hi_capacity():
    """A pool whose chunks are all narrow (hi plane of 0 rows) but whose
    dst-major source lane needs wide chunks: both engines retry the aux
    lanes at full hi capacity, with identical leaves and answers."""
    n = 1024
    rng = np.random.default_rng(6)
    base = rng.integers(0, n - 16, n)
    edges = np.stack([np.repeat(np.arange(n), 16), (base[:, None] + np.arange(16)).reshape(-1)], 1)
    jg = jfg.from_edges(n, edges)
    tg = tfg.from_edges(n, edges, device="cpu")
    jc, tc = jfg.compress_host(jg), tfg.compress_host(tg)
    assert tc.dst.hi_cap == 0
    te, je = make_engine(tc), j_make_engine(jc)
    assert te.caux.srcbd_c.hi_cap == tc.dst.deltas.shape[0]
    assert int(te.caux.srcbd_c.wide.sum()) > 0
    assert_leaves_equal(te.caux, je.caux)
    np.testing.assert_array_equal(talg.bfs_multi(te, SOURCES)[0],
                                  np.asarray(jalg.bfs_multi(je, SOURCES)[0]))


# ---------------------------------------------------------------------------
# compressed stream
# ---------------------------------------------------------------------------

N = 128


@pytest.fixture(scope="module")
def stream_edges():
    return symmetrize(rmat_edges(7, 900, seed=13))


def _assert_mirror(s: tst.AspenStream, r: JaxStream):
    """The port's compressed mirror: every leaf equal to the reference's,
    and its decompression equal to a rebuild from the port's own tree."""
    vt, vj = s.acquire(), r.acquire()
    try:
        assert isinstance(vt.aux[tst.MIRROR], tfg.CompressedPool)
        assert_leaves_equal(vt.aux[tst.MIRROR], vj.aux["flat"])
    finally:
        s.release(vt)
        r.release(vj)
    mirror = s.flat_graph()
    rebuilt = flat_graph_of(s.flat_snapshot(), device="cpu")
    np.testing.assert_array_equal(tfg.to_edge_array(mirror), tfg.to_edge_array(rebuilt))
    np.testing.assert_array_equal(mirror.offsets.numpy(), rebuilt.offsets.numpy())
    if rebuilt.weights is not None:
        np.testing.assert_array_equal(tfg.to_weight_array(mirror), tfg.to_weight_array(rebuilt))


def test_compressed_stream_interleaved_matches_reference(stream_edges):
    keep, updates = tst.make_update_stream(stream_edges, 400, seed=3)
    s = tst.AspenStream(tG.build_graph(N, keep), compressed=True, device="cpu")
    r = JaxStream(jG.build_graph(N, keep), compressed=True)
    _assert_mirror(s, r)
    for i in range(0, updates.shape[0], 100):
        batch = updates[i:i + 100]
        ins, dels = batch[batch[:, 2] == 0, :2], batch[batch[:, 2] == 1, :2]
        s.insert_edges(ins)
        r.insert_edges(ins)
        _assert_mirror(s, r)
        s.delete_edges(dels)
        r.delete_edges(dels)
        _assert_mirror(s, r)
    eng = s.engine("torch")
    assert isinstance(eng, CompressedEngine) and s.engine("torch") is eng
    src = int(stream_edges[0, 0])
    np.testing.assert_array_equal(talg.bfs(eng, src), jalg.bfs(r.engine("jax"), src))
    np.testing.assert_array_equal(talg.connected_components(eng),
                                  jalg.connected_components(r.engine("jax")))
    srcs = np.array([0, 3, 9, 3])
    np.testing.assert_array_equal(s.query_batch(srcs, kind="bfs"),
                                  s.query_batch(srcs, kind="bfs", backend="numpy"))


def test_compressed_stream_weighted_inserts_match_reference(stream_edges):
    w = _weights_for(stream_edges)
    half = len(stream_edges) // 2
    s = tst.AspenStream(tG.build_graph(N, stream_edges[:half]), compressed=True, device="cpu")
    r = JaxStream(jG.build_graph(N, stream_edges[:half]), compressed=True)
    s.insert_edges(stream_edges[half:], weights=w[half:], symmetric=False)
    r.insert_edges(stream_edges[half:], weights=w[half:], symmetric=False)
    _assert_mirror(s, r)
    s.delete_edges(stream_edges[:50])
    r.delete_edges(stream_edges[:50])
    _assert_mirror(s, r)
    src = int(stream_edges[0, 0])
    te, je = s.engine("torch"), r.engine("jax")
    assert te.weights is not None
    np.testing.assert_array_equal(np.asarray(talg.sssp(te, src)), np.asarray(jalg.sssp(je, src)))
    np.testing.assert_array_equal(s.query_batch([0, 5], kind="sssp"),
                                  s.query_batch([0, 5], kind="sssp", backend="numpy"))
    np.testing.assert_allclose(talg.pagerank(te, iters=5), jalg.pagerank(je, iters=5),
                               rtol=1e-6, atol=1e-7)


def test_compressed_stream_heals_a_spill():
    """A narrow graph (small hi headroom) takes a batch that turns most
    chunks wide: the recompressed mirror spills its hi plane, the
    publish rebuilds it from the tree, and the result equals the
    reference's (which heals the same way)."""
    n = 1024
    ring = np.stack([np.arange(n), (np.arange(n) + 1) % n], 1)
    rng = np.random.default_rng(4)
    far = np.stack([np.repeat(np.arange(n), 12), rng.integers(0, n, 12 * n)], 1)
    far = far[far[:, 0] != far[:, 1]]
    s = tst.AspenStream(tG.build_graph(n, ring), compressed=True, device="cpu")
    r = JaxStream(jG.build_graph(n, ring), compressed=True)
    s.insert_edges(far)
    r.insert_edges(far)
    assert s.spill_heals == 1
    _assert_mirror(s, r)
    assert not bool(s.engine("torch").cg.dst.spill)


def test_compressed_stream_rejects_a_spilling_graph():
    dsts = np.arange(K + 2, dtype=np.int64) * 32_768
    edges = np.stack([np.zeros_like(dsts), dsts], axis=1)
    n = int(dsts.max()) + 1
    with pytest.raises(ValueError, match="escape"):
        JaxStream(jG.build_graph(n, edges), compressed=True)
    with pytest.raises(ValueError, match="escape"):
        tst.AspenStream(tG.build_graph(n, edges), compressed=True, device="cpu")
    with pytest.raises(ValueError, match="mirror"):
        tst.AspenStream(tG.build_graph(n, edges), compressed=True, mirror=False, device="cpu")


def test_compressed_stream_resident_bytes(stream_edges):
    """The mirror holds ``bytes_ideal`` plus exactly its spare hi rows."""
    s = tst.AspenStream(tG.build_graph(N, stream_edges), compressed=True, device="cpu")
    v = s.acquire()
    try:
        cg = v.aux[tst.MIRROR]
    finally:
        s.release(v)
    stats = tfg.chunk_stats(tfg.decompress(cg))
    spare = cg.dst.hi_cap - int(cg.dst.wide.sum())
    R = cg.dst.deltas.shape[0]
    assert spare == min(R, stats["n_wide"] + max(4, int(np.ceil(tst.HI_HEADROOM * R)))) \
        - stats["n_wide"]
    assert tcz.stream_nbytes(cg.dst) == stats["bytes_ideal"] + spare * CHUNK
    eng = s.engine("torch")
    assert eng.resident_nbytes == tcz.pytree_nbytes(eng.cg) + tcz.pytree_nbytes(eng.caux)
    assert eng.resident_nbytes < TorchEngine(s.flat_graph()).resident_nbytes
