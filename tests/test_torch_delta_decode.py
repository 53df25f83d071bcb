"""The port's chunk delta decode against the JAX reference.

On the CPU the decode wrappers run their plain PyTorch versions; the
reference runs its Pallas kernels in interpret mode through
``repro.kernels.ops`` (padded to whole blocks there, ragged here).  Both
get the same numpy inputs from a seed: padded rows of ragged shapes
(``decode_chunks``), host C-tree pools chunked at hash heads and packed
in uint8 and uint16 with escapes (``decode_pool``), fixed-width int8 and
int16 chunk rows with escapes at columns 0, 1, 127, below 0 and at the
row's end, and adaptive streams built by the reference's encoder (wide
chunks, escapes, an empty hi plane).  Tolerance: exact equality (integer
decode).  The reference's side stays at <= 64 rows, since interpret mode
is slow.

Tests marked ``cuda`` hold the CUDA kernels against their plain versions
on a GPU; they skip on a machine without one.
"""
import ast
import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import chunks as jck
from repro.core import compressed as jcz
from repro.core.hash import is_head_np
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import chunks as tck
from repro_torch.core import compressed as tcz
from repro_torch.kernels import _build
from repro_torch.kernels import delta_decode as dd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

CHUNK = tcz.CHUNK
K = tcz.OVF_SLOTS


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def padded_rows(R, L, seed):
    rng = np.random.default_rng(seed)
    deltas = rng.integers(0, 100, size=(R, L)).astype(np.int32)
    deltas[:, 0] = 0
    anchors = rng.integers(0, 1 << 20, size=R).astype(np.int32)
    return anchors, deltas


@pytest.mark.parametrize("R,L", [(8, 128), (3, 40), (17, 300), (64, 256)])
def test_decode_chunks_matches_reference(R, L):
    anchors, deltas = padded_rows(R, L, seed=R * 1000 + L)
    got = tops.decode_chunks(_t(anchors), _t(deltas))
    want = np.asarray(jops.decode_chunks(jnp.asarray(anchors), jnp.asarray(deltas)))
    assert got.dtype == torch.int32 and tuple(got.shape) == (R, L)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), tref.delta_decode_ref(_t(anchors), _t(deltas)))


def test_decode_chunks_normalizes_anchor_column():
    rng = np.random.default_rng(7)
    anchors, deltas = padded_rows(6, 96, seed=7)
    deltas[:, 0] = rng.integers(1, 1000, 6)  # left in the anchor column
    got = tops.decode_chunks(_t(anchors), _t(deltas)).numpy()
    want = np.asarray(jops.decode_chunks(jnp.asarray(anchors), jnp.asarray(deltas)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, 0], anchors)
    assert int(deltas[0, 0]) != 0  # the caller's array is not written


@pytest.mark.parametrize("R,L", [(0, 5), (4, 0), (1, 1), (5, 1), (3, 129), (2, 4097)])
def test_padded_plain_edges_and_wraparound(R, L):
    """Ragged corners, and int32 wraparound: the plain version and the
    int64 oracle cut to int32 agree bit for bit."""
    rng = np.random.default_rng(R + L)
    deltas = rng.integers(-(2**31), 2**31, size=(R, L), dtype=np.int64).astype(np.int32)
    anchors = rng.integers(-(2**31), 2**31, size=R, dtype=np.int64).astype(np.int32)
    got = dd.delta_decode_padded(_t(anchors), _t(deltas))
    assert got.dtype == torch.int32 and tuple(got.shape) == (R, L)
    np.testing.assert_array_equal(got.numpy(), tref.delta_decode_ref(_t(anchors), _t(deltas)))


def host_pool(seed, n=4000, n_vertices=20):
    """A host C-tree pool: per-vertex sorted neighbour lists laid end to
    end, chunked at vertex starts and at hash heads (b = 128), with gaps
    that escape uint8 (> 254) and uint16 (> 65534)."""
    rng = np.random.default_rng(seed)
    gaps = rng.integers(1, 200, n)
    pick = rng.random(n)
    gaps = np.where(pick < 0.1, rng.integers(255, 60_000, n), gaps)
    gaps = np.where(pick > 0.98, rng.integers(65_535, 1 << 22, n), gaps)
    starts = np.sort(rng.choice(np.arange(1, n), n_vertices - 1, replace=False))
    data = np.cumsum(gaps)
    # each vertex's list restarts low, so chunks never span two vertices
    vstart = np.zeros(n, np.int64)
    vstart[starts] = data[starts - 1]
    data = data - np.maximum.accumulate(vstart)
    heads = np.flatnonzero(is_head_np(data, 128))
    offs = np.unique(np.concatenate([[0], starts, heads, [n]])).astype(np.int64)
    return data.astype(np.int64), offs


@pytest.mark.parametrize("width", ["uint8", "uint16"])
def test_decode_pool_matches_reference(width):
    data, offs = host_pool(seed=3 if width == "uint8" else 4)
    tp, jp = tck.pack_deltas(data, offs, width=width), jck.pack_deltas(data, offs, width=width)
    assert jp.overflow.size > 0 and offs.size - 1 <= 64
    got = tops.decode_pool(tp, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, data)
    np.testing.assert_array_equal(got, tck.unpack_deltas(tp))
    np.testing.assert_array_equal(got, jops.decode_pool(jp))


def test_decode_pool_of_no_chunks_is_empty():
    empty = tck.pack_deltas(np.empty(0, np.int64), np.zeros(1, np.int64))
    got = tops.decode_pool(empty, device="cpu")
    assert got.dtype == np.int64 and got.shape == (0,)
    with pytest.raises(TypeError):
        tops.decode_pool(jck.pack_deltas(np.arange(3), np.array([0, 3])), device="cpu")


def chunk_rows(R, width, seed, n_esc=3):
    """Escape-lane chunk rows in the ChunkedStream layout: ``n_esc``
    escapes per row at ascending columns, plus the corners (column 0, 1,
    127, a negative column, the row's end) spread over the rows."""
    rng = np.random.default_rng(seed)
    lim = 100 if width == 1 else 30_000
    deltas = rng.integers(-lim, lim, size=(R, CHUNK)).astype(np.int8 if width == 1 else np.int16)
    deltas[:, 0] = 0
    ovf_pos = np.full((R, K), CHUNK, np.int32)
    ovf_add = np.zeros((R, K), np.int32)
    corners = [0, 1, 127, -3, CHUNK]
    for r in range(R):
        cols = np.sort(rng.choice(np.arange(2, CHUNK - 1), n_esc, replace=False))
        cols = np.sort(np.append(cols, corners[r % len(corners)]))
        ovf_pos[r, : cols.size] = cols
        ovf_add[r, : cols.size] = rng.integers(-(1 << 20), 1 << 20, cols.size)
        deltas[r, cols[(cols >= 0) & (cols < CHUNK)]] = 0
    anchors = rng.integers(-(1 << 24), 1 << 24, size=R).astype(np.int32)
    return anchors, deltas, ovf_pos, ovf_add


@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("R", [1, 4, 7, 13])
def test_decode_chunked_stream_fixed_matches_reference(R, width):
    a, d, p, v = chunk_rows(R, width, seed=R * 10 + width)
    got = tops.decode_chunked_stream(_t(a), _t(d), _t(p), _t(v))
    want = np.asarray(jops.decode_chunked_stream(*map(jnp.asarray, (a, d, p, v))))
    assert got.dtype == torch.int32 and tuple(got.shape) == (R, CHUNK)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jref.delta_decode_chunked_ref(
        *map(jnp.asarray, (a, d, p, v)))))
    np.testing.assert_array_equal(got.numpy(),
                                  tref.delta_decode_chunked_ref(*map(_t, (a, d, p, v))))


def _mixed_lane(R, seed):
    """Narrow chunks, narrow chunks with int8 escapes, wide chunks, wide
    chunks with int16 escapes, in turn."""
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


def adaptive_stream(case):
    """(numpy lane, the reference's adaptive stream of it) for ``case``."""
    R = 11
    if case == "narrow_h0":
        lane = np.cumsum(np.random.default_rng(2).integers(-100, 100, R * CHUNK)).astype(np.int32)
        return lane, jcz.encode_stream_adaptive(jnp.asarray(lane), hi_cap=0)
    lane = _mixed_lane(R, seed=5)
    if case == "all_wide":
        lane = np.cumsum(np.random.default_rng(6).integers(-30_000, 30_000, R * CHUNK))
        lane = lane.astype(np.int32)
    n_wide = int(jcz.encode_stream_adaptive(jnp.asarray(lane), hi_cap=R).wide.sum())
    return lane, jcz.encode_stream_adaptive(jnp.asarray(lane), hi_cap=n_wide + 2)


@pytest.mark.parametrize("case", ["mixed", "all_wide", "narrow_h0"])
def test_decode_adaptive_matches_reference(case):
    lane, j = adaptive_stream(case)
    assert not bool(j.spill)
    s = tcz.from_state(*[None if x is None else np.asarray(x) for x in j], device="cpu")
    n_wide = int(s.wide.sum())
    assert {"mixed": 0 < n_wide < s.wide.numel(), "all_wide": n_wide == s.wide.numel(),
            "narrow_h0": s.hi_cap == 0}[case]
    if case == "mixed":
        assert int((s.ovf_pos < CHUNK).sum()) > 0
    got = tops.decode_chunked_stream(s.anchors, s.deltas, s.ovf_pos, s.ovf_add,
                                     hi=s.hi, wide=s.wide).numpy()
    np.testing.assert_array_equal(got.reshape(-1), lane)
    np.testing.assert_array_equal(got, np.asarray(jcz.decode_rows(j)))
    np.testing.assert_array_equal(got, np.asarray(jops.decode_chunked_stream(
        j.anchors, j.deltas, j.ovf_pos, j.ovf_add, hi=j.hi, wide=j.wide)))
    np.testing.assert_array_equal(tcz.decode_rows(s).numpy(), got)


@pytest.mark.parametrize("layout", ["fixed1", "fixed2", "adaptive"])
def test_decode_rows_on_cpu_unchanged(layout):
    """``cz.decode_rows`` (now dispatching to the decode module) on the
    CPU against the reference's, on streams each package encodes."""
    lane = _mixed_lane(9, seed=11)[: 9 * CHUNK - 5]
    if layout == "adaptive":
        t = tcz.encode_stream_adaptive(_t(lane), hi_cap=9)
        j = jcz.encode_stream_adaptive(jnp.asarray(lane), hi_cap=9)
    else:
        w = int(layout[-1])
        t, j = tcz.encode_stream(_t(lane), width=w), jcz.encode_stream(jnp.asarray(lane), width=w)
    got = tcz.decode_rows(t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcz.decode_rows(j)))
    assert bool(t.spill) == (layout == "fixed1")  # > 8 int8 escapes in a wide chunk
    if not bool(t.spill):
        np.testing.assert_array_equal(tcz.decode_stream(t, lane.size).numpy(), lane)


def test_cpu_wrappers_take_plain_and_count_no_launch():
    a, d, p, v = map(_t, chunk_rows(5, 2, seed=1))
    _, j = adaptive_stream("mixed")
    s = tcz.from_state(*[None if x is None else np.asarray(x) for x in j], device="cpu")
    before = dict(dd.LAUNCHES)
    got = [dd.delta_decode_padded(a, d.to(torch.int32)),
           dd.delta_decode_chunked(a, d, p, v),
           dd.delta_decode_chunked_adaptive(s.anchors, s.deltas, s.hi, s.wide, s.ovf_pos,
                                            s.ovf_add)]
    assert dd.LAUNCHES == before
    assert set(dd.LAUNCHES) == {"delta_decode_padded", "delta_decode_chunked",
                                "delta_decode_chunked_adaptive"}
    want = [dd.delta_decode_padded_plain(a, d.to(torch.int32)),
            dd.delta_decode_chunked_plain(a, d, p, v),
            dd.delta_decode_chunked_adaptive_plain(s.anchors, s.deltas, s.hi, s.wide,
                                                   s.ovf_pos, s.ovf_add)]
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    dd.reset_launches()
    assert set(dd.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("bad", ["anchors_dtype", "padded_int16", "rows", "ovf_shape",
                                 "adaptive_int16", "hi_width", "wide_dtype", "strided"])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    a, d, p, v = map(_t, chunk_rows(4, 1, seed=2))
    hi, wide = torch.zeros((2, CHUNK), dtype=torch.int8), torch.zeros(4, dtype=torch.bool)
    with pytest.raises((TypeError, ValueError)):
        if bad == "anchors_dtype":
            dd.delta_decode_chunked(a.long(), d, p, v)
        elif bad == "padded_int16":
            dd.delta_decode_padded(a, d.to(torch.int16))
        elif bad == "rows":
            dd.delta_decode_padded(a[:-1], d.to(torch.int32))
        elif bad == "ovf_shape":
            dd.delta_decode_chunked(a, d, p[:, :-1], v)
        elif bad == "adaptive_int16":
            dd.delta_decode_chunked_adaptive(a, d.to(torch.int16), hi, wide, p, v)
        elif bad == "hi_width":
            dd.delta_decode_chunked_adaptive(a, d, hi[:, :64], wide, p, v)
        elif bad == "wide_dtype":
            dd.delta_decode_chunked_adaptive(a, d, hi, wide.to(torch.int32), p, v)
        else:
            dd.delta_decode_padded(a, d.to(torch.int32).T.contiguous().T)


def test_decode_module_imports_nothing_from_core():
    """``core/compressed`` imports the decode module, and ``segment_reduce``
    imports ``core/compressed``: an import back would be a cycle."""
    tree = ast.parse(Path(dd.__file__).read_text())
    names = [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    names += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    assert names and not any("core" in x or "jax" in x or x.startswith("repro") for x in names)


def test_build_target_hashes_headers(tmp_path, monkeypatch):
    """An edited ``csrc/*.cuh`` header rebuilds every library (the sources
    include it); an edited ``.cu`` rebuilds only its own."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    names = ("delta_decode", "segment_reduce")
    before = {n: _build._target(n) for n in names}
    assert before == {n: _build._target(n) for n in names}  # stable
    header = csrc / "chunk_decode.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: _build._target(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    src = csrc / "segment_reduce.cu"
    src.write_bytes(src.read_bytes() + b"\n")
    assert _build._target("segment_reduce") != after["segment_reduce"]
    assert _build._target("delta_decode") == after["delta_decode"]
    (csrc / "extra.cuh").write_bytes(b"#pragma once\n")  # a new header counts too
    assert _build._target("delta_decode") != after["delta_decode"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run: python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("R,L", [(1, 1), (3, 40), (17, 300), (1000, 257), (2, 4097)])
def test_cuda_padded_kernel_matches_plain(cuda, R, L):
    rng = np.random.default_rng(R + L)
    d = _t(rng.integers(-(2**31), 2**31, size=(R, L), dtype=np.int64).astype(np.int32)).to(cuda)
    a = _t(rng.integers(-(2**31), 2**31, size=R, dtype=np.int64).astype(np.int32)).to(cuda)
    before = dd.LAUNCHES["delta_decode_padded"]
    got = dd.delta_decode_padded(a, d)
    torch.cuda.synchronize()
    assert dd.LAUNCHES["delta_decode_padded"] == before + 1
    assert torch.equal(got, dd.delta_decode_padded_plain(a, d))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["fixed1", "fixed2", "mixed", "all_wide", "narrow_h0"])
def test_cuda_chunked_kernels_match_plain(cuda, case):
    if case.startswith("fixed"):
        a, d, p, v = (x.to(cuda) for x in map(_t, chunk_rows(1001, int(case[-1]), seed=3)))
        hi = wide = None
    else:
        _, j = adaptive_stream(case)
        s = tcz.from_state(*[None if x is None else np.asarray(x) for x in j], device=cuda)
        a, d, p, v, hi, wide = s.anchors, s.deltas, s.ovf_pos, s.ovf_add, s.hi, s.wide
    before = sum(dd.LAUNCHES.values())
    got = tops.decode_chunked_stream(a, d, p, v, hi=hi, wide=wide)
    torch.cuda.synchronize()
    assert sum(dd.LAUNCHES.values()) == before + 1
    if hi is None:
        want = dd.delta_decode_chunked_plain(a, d, p, v)
    else:
        want = dd.delta_decode_chunked_adaptive_plain(a, d, hi, wide, p, v)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_decode_pool_matches_unpack(cuda):
    data, offs = host_pool(seed=9, n=200_000, n_vertices=3000)
    for width in ("uint8", "uint16"):
        p = tck.pack_deltas(data, offs, width=width)
        np.testing.assert_array_equal(tops.decode_pool(p, device=cuda), tck.unpack_deltas(p))
