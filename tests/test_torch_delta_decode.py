"""The port's chunk delta decode against the JAX reference.

On the CPU the decode wrappers run their plain PyTorch versions; the
reference runs its Pallas kernels in interpret mode through
``repro.kernels.ops`` (padded to whole blocks there, ragged here).  Both
get the same numpy inputs from a seed: padded rows of ragged shapes
(``decode_chunks``), host C-tree pools chunked at hash heads and packed
in uint8 and uint16 with escapes (``decode_pool``), fixed-width int8 and
int16 chunk rows with escapes at columns 0, 1, 127, below 0 and at the
row's end, adaptive streams built by the reference's encoder (wide
chunks, escapes, an empty hi plane), and streams built by hand at the
kernels' tile edges (rows a warp and rows a block, each +-1), with 0, 1
and 32 escape slots, tables of padding only, and adaptive tags all wide,
all narrow, straddling a tile edge, past the hi plane (the clamp) or with
H = 0.  Tolerance: exact equality (integer decode).  The reference's side
stays at <= 64 rows, since interpret mode is slow; its Pallas kernel takes
no table of 0 slots, so a 0-slot stream is held against the same stream
with one padding slot.

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
# The chunked kernels' tile (csrc/delta_decode.cu): rows a warp holds, rows
# a block decodes, rows whose tags a block of the adaptive pre-pass counts;
# test_cuda_chunked_plan holds the library to them.
ROWS_PER_WARP, ROWS_PER_BLOCK, ROWS_PER_PREFIX_BLOCK = 4, 32, 8192
TILE_EDGES = sorted({n + e for n in (ROWS_PER_WARP, ROWS_PER_BLOCK) for e in (-1, 0, 1)})


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
@pytest.mark.parametrize("R", sorted({1, 7, 13, *TILE_EDGES}))
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


def hand_rows(R, n_slots, seed, width=1, table="mixed"):
    """Chunk rows built by hand: anchors over the whole int32 range and
    escape values too (the decode wraps); with ``table="mixed"`` about half
    the entries act, at random columns and the corners (below 0, 0, 1,
    127), the rest are padding at 128 and past it, with values that must
    never act; ``table="padding"`` pads every entry."""
    rng = np.random.default_rng(seed)
    lim = 128 if width == 1 else 1 << 15
    deltas = rng.integers(-lim, lim, (R, CHUNK)).astype(np.int8 if width == 1 else np.int16)
    deltas[:, 0] = 0
    anchors = rng.integers(-(2**31), 2**31, R, dtype=np.int64).astype(np.int32)
    cols = rng.choice(np.array([-7, -1, 0, 1, CHUNK - 1, *range(2, CHUNK - 1)]), (R, n_slots))
    live = rng.random((R, n_slots)) < (0.5 if table == "mixed" else 0.0)
    pad = rng.choice(np.array([CHUNK, CHUNK + 1, 1 << 30]), (R, n_slots))
    ovf_pos = np.where(live, cols, pad).astype(np.int32)
    ovf_add = rng.integers(-(2**31), 2**31, (R, n_slots), dtype=np.int64).astype(np.int32)
    return anchors, deltas, ovf_pos, ovf_add


# adaptive streams built by hand: case -> (R, wide rows, H, escape slots)
_TAGS = {
    "all_narrow": (37, lambda R: np.zeros(R, bool), 3, K),
    "all_wide": (37, lambda R: np.ones(R, bool), 37, K),
    "straddle": (70, lambda R: np.isin(np.arange(R), [*range(29, 36), *range(62, 67)]), 12, K),
    "past_cap": (45, lambda R: np.arange(R) % 3 != 1, 7, K),  # 30 wide chunks, 7 hi rows
    "h0": (33, lambda R: np.arange(R) % 2 == 0, 0, K),
    "slots0": (33, lambda R: np.arange(R) % 4 == 0, 9, 0),
    "slots1": (33, lambda R: np.arange(R) % 4 == 0, 9, 1),
    "slots32": (33, lambda R: np.arange(R) % 4 == 0, 9, 32),
    **{f"edge{R}": (R, lambda R: np.arange(R) % 5 != 2, R, K) for R in TILE_EDGES},
}


def hand_adaptive(case, seed=0):
    """(anchors, int8 lane, ovf_pos, ovf_add, hi, wide) for ``_TAGS[case]``,
    the hi plane random."""
    R, tags, H, n_slots = _TAGS[case]
    a, d, p, v = hand_rows(R, n_slots, seed=seed + R)
    hi = np.random.default_rng(seed + 1).integers(-128, 128, (H, CHUNK)).astype(np.int8)
    return a, d, p, v, hi, tags(R)


def reference_decode(a, d, p, v, hi=None, wide=None):
    """The reference's ``ops.decode_chunked_stream`` (its Pallas kernels,
    in interpret mode); a table of 0 slots goes as one padding slot."""
    if p.shape[1] == 0:
        p, v = np.full((p.shape[0], 1), CHUNK, np.int32), np.zeros((p.shape[0], 1), np.int32)
    j = [jnp.asarray(x) for x in (a, d, p, v)]
    if hi is None:
        return np.asarray(jops.decode_chunked_stream(*j))
    return np.asarray(jops.decode_chunked_stream(*j, hi=jnp.asarray(hi), wide=jnp.asarray(wide)))


@pytest.mark.parametrize("table", ["mixed", "padding"])
@pytest.mark.parametrize("n_slots", [0, 1, 32])
@pytest.mark.parametrize("width", [1, 2])
def test_decode_chunked_tables_match_reference(width, n_slots, table):
    a, d, p, v = hand_rows(37, n_slots, seed=100 * width + n_slots, width=width, table=table)
    got = tops.decode_chunked_stream(*map(_t, (a, d, p, v)))
    np.testing.assert_array_equal(got.numpy(), reference_decode(a, d, p, v))
    np.testing.assert_array_equal(got.numpy(), dd.delta_decode_chunked_plain(*map(_t, (a, d, p, v))))
    if table == "padding":  # no entry acts: the plain cumsum
        want = a[:, None].astype(np.int64) + np.cumsum(d.astype(np.int64), axis=1)
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("case", list(_TAGS))
def test_decode_adaptive_hand_built_matches_reference(case):
    a, d, p, v, hi, wide = hand_adaptive(case)
    got = tops.decode_chunked_stream(*map(_t, (a, d, p, v)), hi=_t(hi), wide=_t(wide))
    assert got.dtype == torch.int32 and tuple(got.shape) == (a.size, CHUNK)
    j = jcz.ChunkedStream(*map(jnp.asarray, (a, d, p, v)), jnp.asarray(False), jnp.asarray(hi),
                          jnp.asarray(wide))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jcz.decode_rows(j)).astype(np.int32))
    if case == "h0":
        # with no hi plane the codec reads every chunk narrow (no wide chunk
        # exists without spilling, reference compressed.py:236); the
        # reference's Pallas path reads a tagged chunk's lane as unsigned
        # bytes there, so it is held on the rows not tagged
        narrow = ~wide
        np.testing.assert_array_equal(got.numpy()[narrow],
                                      reference_decode(a, d, p, v, hi, wide)[narrow])
        return
    np.testing.assert_array_equal(got.numpy(), reference_decode(a, d, p, v, hi, wide))
    if case == "past_cap":  # wide chunks past the plane read its last row
        assert int(wide.sum()) > hi.shape[0]
        rows = dd.hi_rows(_t(wide), hi.shape[0])
        assert int(rows[_t(wide)].max()) == hi.shape[0] - 1


def test_check_lane_aligned():
    """The kernels load a lane's 4 deltas as one word, 4 hi bytes as one
    word and the wide tags 16 at a time: a base off that alignment raises
    (on the card; here the check alone)."""
    lane8 = torch.zeros(2 * CHUNK + 8, dtype=torch.int8)
    lane16 = torch.zeros(2 * CHUNK + 8, dtype=torch.int16)
    hi = torch.zeros(CHUNK + 8, dtype=torch.int8)
    wide = torch.zeros(64, dtype=torch.bool)
    assert all(x.data_ptr() % 16 == 0 for x in (lane8, lane16, hi, wide))  # the allocator's
    dd.check_lane_aligned(lane8[4:], hi[4:], wide[16:])
    dd.check_lane_aligned(lane16[4:])
    for bad in ((lane8[1:],), (lane8[2:],), (lane16[2:],), (lane8, hi[1:]),
                (lane8, hi, wide[8:])):
        with pytest.raises(ValueError):
            dd.check_lane_aligned(*bad)


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


def corner_arrays(case):
    """numpy (anchors, deltas, ovf_pos, ovf_add, hi, wide) of a corner case
    (hi and wide None on a fixed layout): ``rows{R}_int{8|16}``,
    ``slots{K}_{mixed|padding}_int{8|16}`` or ``adaptive_{_TAGS key}``."""
    if case.startswith("adaptive_"):
        return hand_adaptive(case[len("adaptive_"):], seed=7)
    width = 1 if case.endswith("int8") else 2
    if case.startswith("rows"):
        R = int(case[4:case.index("_")])
        return (*hand_rows(R, K, seed=R, width=width), None, None)
    n_slots, table = case.split("_")[0][5:], case.split("_")[1]
    return (*hand_rows(37, int(n_slots), seed=3, width=width, table=table), None, None)


CORNERS = ([f"rows{R}_int{8 * w}" for R in TILE_EDGES for w in (1, 2)]
           + [f"slots{k}_{t}_int{8 * w}" for k in (0, 1, 32) for t in ("mixed", "padding")
              for w in (1, 2)]
           + [f"adaptive_{c}" for c in _TAGS] + ["adaptive_prefix_edges"])


def prefix_edge_arrays():
    """An adaptive stream across the pre-pass's blocks: 3 blocks and 5 rows,
    tags random and wide past the plane near the end, so the look-back
    spans blocks and each block edge falls inside a run of wide chunks."""
    R = 3 * ROWS_PER_PREFIX_BLOCK + 5
    a, d, p, v = hand_rows(R, K, seed=11)
    rng = np.random.default_rng(12)
    wide = rng.random(R) < 0.4
    for e in range(1, 4):
        wide[e * ROWS_PER_PREFIX_BLOCK - 3:e * ROWS_PER_PREFIX_BLOCK + 3] = True
    hi = rng.integers(-128, 128, (int(wide.sum()) - 20, CHUNK)).astype(np.int8)
    return a, d, p, v, hi, wide


@pytest.mark.cuda
def test_cuda_chunked_plan(cuda):
    """The tile the cases here are cut to."""
    assert dd.chunked_plan() == {"rows_per_warp": ROWS_PER_WARP, "rows_per_block": ROWS_PER_BLOCK,
                                 "rows_per_prefix_block": ROWS_PER_PREFIX_BLOCK}


@pytest.mark.cuda
@pytest.mark.parametrize("case", CORNERS)
def test_cuda_chunked_corners_match_plain(cuda, case):
    """The kernel against its plain version at the tile edges, the table
    corners and the tag patterns; two calls give the same bits, one
    launch each."""
    arrays = prefix_edge_arrays() if case == "adaptive_prefix_edges" else corner_arrays(case)
    a, d, p, v, hi, wide = (None if x is None else _t(x).to(cuda) for x in arrays)
    before = sum(dd.LAUNCHES.values())
    got = [tops.decode_chunked_stream(a, d, p, v, hi=hi, wide=wide) for _ in range(2)]
    torch.cuda.synchronize()
    assert sum(dd.LAUNCHES.values()) == before + 2
    if hi is None:
        want = dd.delta_decode_chunked_plain(a, d, p, v)
    else:
        want = dd.delta_decode_chunked_adaptive_plain(a, d, hi, wide, p, v)
    assert torch.equal(got[0], want) and torch.equal(got[1], want)


@pytest.mark.cuda
def test_cuda_adaptive_decode_on_two_streams(cuda):
    """Two adaptive decodes at once on two streams (each stream has its own
    look-back buffer), three calls each, against the plain versions."""
    lanes = []
    for R, seed in ((50_000, 1), (30_001, 2)):
        a, d, p, v = hand_rows(R, K, seed=seed)
        wide = np.random.default_rng(seed).random(R) < 0.3
        hi = np.random.default_rng(seed + 1).integers(-128, 128, (int(wide.sum()), CHUNK))
        lanes.append([_t(x).to(cuda) for x in (a, d, hi.astype(np.int8), wide, p, v)])
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(3):
        for i, (st, args) in enumerate(zip(streams, lanes)):
            with torch.cuda.stream(st):
                got[i].append(dd.delta_decode_chunked_adaptive(*args))
    torch.cuda.synchronize()
    for outs, args in zip(got, lanes):
        want = dd.delta_decode_chunked_adaptive_plain(*args)
        assert all(torch.equal(o, want) for o in outs)
    keys = [k for k in _build._SCRATCH if k[0] == "decode_lookback"]
    assert {k[2] for k in keys} >= {s.cuda_stream for s in streams}


@pytest.mark.cuda
def test_cuda_chunked_rejects_misaligned_lane(cuda):
    """A lane whose base is off the 4-delta alignment raises in the decode
    and in the chunked segment sums (both load a lane's 4 deltas as one
    word); nothing is copied and nothing falls back."""
    from repro_torch.kernels import segment_reduce as sr

    a, d, p, v = (_t(x).to(cuda) for x in hand_rows(4, K, seed=5))
    buf = torch.zeros(4 * CHUNK + 1, dtype=torch.int8, device=cuda)
    lane = buf[1:].view(4, CHUNK)
    lane.copy_(d)
    before = dict(dd.LAUNCHES)
    with pytest.raises(ValueError):
        dd.delta_decode_chunked(a, lane, p, v)
    with pytest.raises(ValueError):
        sr.segment_sum_sorted_chunked(a, lane, p, v, torch.ones((4 * CHUNK, 1), device=cuda), 8)
    assert dd.LAUNCHES == before
