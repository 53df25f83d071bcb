"""The port's chunked segment-sum wrappers against the JAX reference kernels.

On the CPU the wrappers run their plain PyTorch versions (decode, then
``index_add_``); the reference runs its Pallas kernels in interpret mode
through ``repro.kernels.ops.segment_sum(_weighted)_chunked``, which pads
to whole blocks.  Both get the same streams, encoded from the same numpy
lane by each package's own encoder, at chunk counts that are not block
multiples: fixed int8 and int16 lanes with escapes, adaptive lanes mixing
narrow and wide chunks (escapes in both, a hi plane with spare rows), and
a narrow-only adaptive lane with an empty hi plane.  The lane ascends and
its last tenth decodes to ``n_out`` or more (pads, dropped).  Tolerance
rtol 1e-5, atol 1e-6: the reference sums in one-hot blocks, the plain
version with ``index_add_``, so the float32 summation order differs.

Tests marked ``cuda`` hold the CUDA kernels against the plain versions on
a GPU; they skip on a machine without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressed as jcz
from repro.kernels import ops as jops
from repro_torch.core import compressed as tcz
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segment_reduce as sr

CHUNK = tcz.CHUNK


def ascending_lane(R: int, kind: str, seed: int, tail: int = 37):
    """(values int32[R * CHUNK - tail], n_out): an ascending lane whose
    chunks carry the deltas of ``kind``; values past the 90th percentile
    are cut to ``n_out`` (pads)."""
    rng = np.random.default_rng(seed)
    gaps = rng.integers(0, 3, (R, CHUNK)).astype(np.int64)
    for r in range(R):
        cols = rng.permutation(np.arange(1, CHUNK))
        j = 1 + r % tcz.OVF_SLOTS
        role = r % 4 if kind == "mixed" else {"int8": 1, "int16": 3}[kind]
        if role == 1 and r % 3 != 2:  # narrow chunk with int8 escapes
            gaps[r, cols[:j]] = rng.integers(128, 3000, j)
        if role in (2, 3):  # wide chunk: > k deltas over int8
            gaps[r, cols[j:j + 12]] = rng.integers(200, 3000, 12)
        if role == 3 and r % 3 == 1:  # int16 escapes
            gaps[r, cols[:j]] = rng.integers(32_768, 40_000, j)
    vals = np.cumsum(gaps.reshape(-1))[: R * CHUNK - tail]
    n_out = int(vals[int(0.9 * vals.size)])
    return np.minimum(vals, n_out).astype(np.int32), n_out


# (layout, lane kind): fixed width 1/2, adaptive with spare hi rows,
# adaptive narrow-only with H = 0
LAYOUTS = [("fixed1", "int8"), ("fixed2", "int16"), ("adaptive", "mixed"), ("adaptive0", "int8")]


def encode_both(vals, layout):
    """The same lane through each package's encoder: (port, reference)."""
    if layout.startswith("fixed"):
        w = int(layout[-1])
        return (tcz.encode_stream(torch.from_numpy(vals), width=w),
                jcz.encode_stream(jnp.asarray(vals), width=w))
    hi_cap = 0
    if layout == "adaptive":
        probe = tcz.encode_stream_adaptive(torch.from_numpy(vals), hi_cap=vals.size // CHUNK + 1)
        hi_cap = int(probe.wide.sum()) + 3  # headroom rows past the wide count
    return (tcz.encode_stream_adaptive(torch.from_numpy(vals), hi_cap=hi_cap),
            jcz.encode_stream_adaptive(jnp.asarray(vals), hi_cap=hi_cap))


def _port_sum(s, msg, n_out, w=None):
    args = (s.anchors, s.deltas, s.ovf_pos, s.ovf_add)
    if w is None:
        return tops.segment_sum_chunked(*args, msg, n_out, hi=s.hi, wide=s.wide)
    return tops.segment_sum_weighted_chunked(*args, w, msg, n_out, hi=s.hi, wide=s.wide)


def _ref_sum(s, msg, n_out, w=None):
    args = (s.anchors, s.deltas, s.ovf_pos, s.ovf_add)
    if w is None:
        return jops.segment_sum_chunked(*args, msg, n_out, hi=s.hi, wide=s.wide)
    return jops.segment_sum_weighted_chunked(*args, w, msg, n_out, hi=s.hi, wide=s.wide)


def _inputs(layout, kind, R, D, seed):
    vals, n_out = ascending_lane(R, kind, seed)
    ts, js = encode_both(vals, layout)
    assert not bool(ts.spill) and not bool(js.spill)
    rng = np.random.default_rng(seed + 1)
    msg = rng.standard_normal((R * CHUNK, D)).astype(np.float32)
    w = rng.random(R * CHUNK).astype(np.float32)
    return vals, n_out, ts, js, msg, w


# Lanes at the corners of the kernels' partition (tiles of 32 chunk rows,
# runs crossing chunk and tile edges): (values int32[R * CHUNK], n_out).
# ``big`` sizes them to span many tiles (about 10^6 slots, a row of
# 3 * 10^5) for the card.  Gaps stay small, so no layout spills.
EDGE_LANES = ["chunk_edge_rows", "one_row", "hub", "empty_rows", "all_pads", "e1", "negative"]


def edge_lane(name: str, big: bool = False, seed: int = 0):
    rng = np.random.default_rng(seed)
    R = 7813 if big else 40
    E, hub = R * CHUNK, (300_000 if big else 3_000)
    if name == "chunk_edge_rows":  # each row fills whole chunks: rows start on chunk edges
        rows = np.repeat(np.arange(R // 2) * 3, 2)
        vals, n_out = np.repeat(rows, CHUNK), 3 * (R // 2) - 3 * (R // 20) - 3
    elif name == "one_row":
        vals, n_out = np.full(E, 5), 9
    elif name == "hub":
        small = np.cumsum(rng.integers(1, 3, E))
        cut = int(small[E // 3])
        vals = np.sort(np.concatenate([small[: E - hub], np.full(hub, cut)]))
        n_out = int(vals[-1]) - 20
    elif name == "empty_rows":  # empty rows before the first key, between keys, after the last
        vals = 100 + np.cumsum(rng.integers(0, 20, E) * (rng.random(E) < 0.3))
        n_out = int(vals[-1]) + 50
    elif name == "all_pads":
        vals, n_out = np.full(E, 61), 50
    elif name == "e1":  # one valid slot, the rest pads
        vals, n_out = np.concatenate([[3], np.full(E - 1, 10)]), 10
    else:  # negative ids first
        vals = -40 + np.cumsum(rng.integers(0, 3, E))
        n_out = int(vals[-1]) - 30
    return np.minimum(vals, n_out).astype(np.int32) if name != "all_pads" else vals.astype(
        np.int32), n_out


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("layout,kind", LAYOUTS)
@pytest.mark.parametrize("case", EDGE_LANES)
def test_chunked_partition_edge_cases(case, layout, kind, weighted):
    """The partition's corners through every layout: the plain version
    against the reference's kernel, at rtol 1e-5 and atol 1e-6 * max|out|
    (rows of hundreds of terms cancel to near 0 in two summation orders)."""
    vals, n_out = edge_lane(case)
    ts, js = encode_both(vals, layout)
    assert not bool(ts.spill) and not bool(js.spill)
    R, D = ts.anchors.shape[0], 2
    rng = np.random.default_rng(R)
    msg = rng.standard_normal((R * CHUNK, D)).astype(np.float32)
    w = rng.random(R * CHUNK).astype(np.float32)
    got = _port_sum(ts, torch.from_numpy(msg), n_out,
                    torch.from_numpy(w) if weighted else None).numpy()
    want = np.asarray(_ref_sum(js, jnp.asarray(msg), n_out, jnp.asarray(w) if weighted else None))
    assert got.shape == (n_out, D)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("layout,kind", LAYOUTS)
@pytest.mark.parametrize("R,D", [(1, 3), (7, 1), (11, 8)])
def test_chunked_plain_matches_reference_kernel(layout, kind, R, D, weighted):
    vals, n_out, ts, js, msg, w = _inputs(layout, kind, R, D, seed=R * 31 + D)
    if kind != "int8" or layout == "fixed1":
        assert int((ts.ovf_pos < CHUNK).sum()) > 0 or R == 1  # escapes are exercised
    got = _port_sum(ts, torch.from_numpy(msg), n_out,
                    torch.from_numpy(w) if weighted else None).numpy()
    want = np.asarray(_ref_sum(js, jnp.asarray(msg), n_out, jnp.asarray(w) if weighted else None))
    assert got.shape == (n_out, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layout,kind", LAYOUTS)
def test_chunked_plain_matches_decode_oracle(layout, kind):
    """Plain version == the float64 oracle over the oracle's decode of the
    same lane (and that decode is the original lane, padded)."""
    R, D = 13, 2
    vals, n_out, ts, _, msg, w = _inputs(layout, kind, R, D, seed=5)
    d = tcz.adaptive_deltas(ts) if ts.adaptive else ts.deltas
    dec = tref.delta_decode_chunked_ref(ts.anchors, d, ts.ovf_pos, ts.ovf_add).reshape(-1)
    np.testing.assert_array_equal(dec.numpy()[: vals.size], vals)
    np.testing.assert_array_equal(dec.numpy()[vals.size:], vals[-1])
    m, wt = torch.from_numpy(msg), torch.from_numpy(w)
    np.testing.assert_allclose(_port_sum(ts, m, n_out, wt).numpy(),
                               tref.segment_sum_weighted_sorted_ref(dec, wt, m, n_out).numpy(),
                               rtol=1e-5, atol=1e-6)


def test_cpu_chunked_wrappers_take_plain_and_count_no_launch():
    _, n_out, ts, _, msg, w = _inputs("adaptive", "mixed", 6, 2, seed=9)
    fs, _ = encode_both(ascending_lane(6, "int16", 9)[0], "fixed2")
    m, wt = torch.from_numpy(msg), torch.from_numpy(w)
    before = dict(sr.LAUNCHES)
    a = sr.segment_sum_sorted_chunked_adaptive(ts.anchors, ts.deltas, ts.hi, ts.wide,
                                               ts.ovf_pos, ts.ovf_add, m, n_out)
    b = sr.segment_sum_weighted_chunked(fs.anchors, fs.deltas, fs.ovf_pos, fs.ovf_add, wt, m, 50)
    assert sr.LAUNCHES == before
    torch.testing.assert_close(a, sr.segment_sum_sorted_chunked_plain(
        ts.anchors, ts.deltas, ts.ovf_pos, ts.ovf_add, m, n_out, ts.hi, ts.wide))
    assert b.shape == (50, 2)
    assert set(sr.LAUNCHES) >= {"segment_sum_chunked", "segment_sum_weighted_chunked",
                                "segment_sum_chunked_adaptive",
                                "segment_sum_weighted_chunked_adaptive"}


@pytest.mark.parametrize("bad", ["anchors_dtype", "lane_width", "adaptive_int16", "ovf_shape",
                                 "msg_rows", "w_shape", "wide_dtype", "too_many_slots"])
def test_chunked_wrappers_reject_what_the_kernel_does_not_take(bad):
    _, n_out, s, _, msg, w = _inputs("adaptive", "mixed", 4, 2, seed=3)
    a, d, p, v, hi, wide = s.anchors, s.deltas, s.ovf_pos, s.ovf_add, s.hi, s.wide
    m, wt = torch.from_numpy(msg), torch.from_numpy(w)
    if bad == "anchors_dtype":
        a = a.long()
    elif bad == "lane_width":
        d = d[:, :64].contiguous()
    elif bad == "adaptive_int16":
        d = d.to(torch.int16)
    elif bad == "ovf_shape":
        p = p[:-1]
    elif bad == "msg_rows":
        m = m[:-1]
    elif bad == "w_shape":
        wt = wt[:-1]
    elif bad == "wide_dtype":
        wide = wide.to(torch.int32)
    else:
        p = torch.full((4, 33), CHUNK, dtype=torch.int32)
        v = torch.zeros((4, 33), dtype=torch.int32)
    with pytest.raises((TypeError, ValueError)):
        sr.segment_sum_weighted_chunked_adaptive(a, d, hi, wide, p, v, wt, m, n_out)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run: python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("layout,kind", LAYOUTS)
@pytest.mark.parametrize("R,D", [(1, 1), (11, 8), (1001, 64)])
def test_cuda_chunked_kernels_match_plain(cuda, layout, kind, R, D):
    _, n_out, ts, _, msg, w = _inputs(layout, kind, R, D, seed=R + D)
    s = tcz.ChunkedStream(*[None if t is None else t.to(cuda) for t in ts])
    m, wt = torch.from_numpy(msg).to(cuda), torch.from_numpy(w).to(cuda)
    before = dict(sr.LAUNCHES)
    got = [_port_sum(s, m, n_out), _port_sum(s, m, n_out, wt)]
    torch.cuda.synchronize()
    assert sum(sr.LAUNCHES.values()) == sum(before.values()) + 2
    # a fixed summation order: the same bits on every call (checked before
    # the plain versions' outputs exist: at R = 1001, D = 64 fixed2, each
    # output is 16 GB)
    assert torch.equal(got[0], _port_sum(s, m, n_out))
    assert torch.equal(got[1], _port_sum(s, m, n_out, wt))
    args = (s.anchors, s.deltas, s.ovf_pos, s.ovf_add)
    # one plain output at a time, compared 16 columns at a time, so the
    # comparison's temporaries fit beside the outputs on an 80 GB card
    for a, weights in zip(got, (None, wt)):
        b = (sr.segment_sum_sorted_chunked_plain(*args, m, n_out, s.hi, s.wide) if weights is None
             else sr.segment_sum_weighted_chunked_plain(*args, wt, m, n_out, s.hi, s.wide))
        atol = 1e-6 * float(torch.maximum(b.max(), -b.min()))  # max|b| without a copy
        for c in range(0, D, 16):
            torch.testing.assert_close(a[:, c:c + 16], b[:, c:c + 16], rtol=1e-5, atol=atol)
        del b


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 8])
@pytest.mark.parametrize("layout,kind", LAYOUTS)
@pytest.mark.parametrize("case", EDGE_LANES)
def test_cuda_chunked_partition_edge_cases(cuda, case, layout, kind, D):
    """The edge lanes at sizes that span many tiles, held against the
    float64 oracle over the plain decode (the plain version's atomics sum
    a row of 3 * 10^5 terms in one float32 chain in no fixed order, whose
    error nears the tolerance itself).  Two calls give the same bits."""
    vals, n_out = edge_lane(case, big=True)
    ts, _ = encode_both(vals, layout) if layout.startswith("fixed") else (
        tcz.encode_stream_adaptive(torch.from_numpy(vals), hi_cap=0 if layout == "adaptive0" else
                                   vals.size // CHUNK), None)
    assert not bool(ts.spill)
    s = tcz.ChunkedStream(*[None if t is None else t.to(cuda) for t in ts])
    gen = torch.Generator(device=cuda).manual_seed(D)
    m = torch.randn((vals.size, D), generator=gen, device=cuda)
    wt = torch.rand(vals.size, generator=gen, device=cuda)
    dec = sr._decoded(s.anchors, s.deltas, s.ovf_pos, s.ovf_add, s.hi, s.wide)
    for weights in (None, wt):
        got = _port_sum(s, m, n_out, weights)
        want = tref.segment_sum_weighted_sorted_ref(dec, weights, m, n_out).float()
        atol = 1e-6 * max(float(want.abs().max()), 1e-30)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)
        assert torch.equal(got, _port_sum(s, m, n_out, weights))
