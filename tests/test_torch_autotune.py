"""The port's launch-tile autotuner (``repro_torch.kernels.autotune``)
against the reference's (``repro.kernels.autotune``): the same bucketing
and key dims, and a counterpart of each test in ``tests/test_autotune.py``
(winner-cache hit/miss, sweep determinism under a pinned grid, vetoes,
the opt-in disk table, consult-once per shape bucket through dispatch).
Beyond the reference: one consult and one sweep per key from six threads,
sweep launches counted apart from the kernels' own, and, on the card
(``cuda``), every candidate tile of every tuned kernel held against its
plain version and a sweep that picks one of them."""
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro.kernels import autotune as jat
from repro_torch.kernels import _build, csr_spmm
from repro_torch.kernels import autotune
from repro_torch.kernels import ops as kops
from repro_torch.kernels import segment_reduce as sr
from repro_torch.core import compressed as cz


@pytest.fixture(autouse=True)
def _clean_table(monkeypatch):
    """Every test starts from an empty memo, the built-in candidate
    grids, and no disk table / forced sweeping."""
    for var in ("REPRO_TORCH_AUTOTUNE", "REPRO_TORCH_AUTOTUNE_CACHE", "REPRO_AUTOTUNE",
                "REPRO_AUTOTUNE_CACHE"):
        monkeypatch.delenv(var, raising=False)
    autotune.reset()
    autotune.set_candidates(None)
    yield
    autotune.reset()
    autotune.set_candidates(None)


def _zero():
    return lambda: torch.zeros(())


# -- cache key ---------------------------------------------------------------


def test_bucket_rounds_up_to_power_of_two():
    xs = (1, 2, 3, 1000, 1024, 1025, 66_000_000)
    assert [autotune._bucket(x) for x in xs][:6] == [1, 2, 4, 1024, 1024, 2048]
    assert [autotune._bucket(x) for x in xs] == [jat._bucket(x) for x in xs]


@pytest.mark.parametrize("kernel,shape", [
    ("segment_sum", {"E": 900, "n": 500}),
    ("segment_sum_weighted", {"E": 66_000_000, "n": 4_194_304}),
    ("segment_sum_chunked", {"R": 515_000, "n": 4_194_304}),
    ("spmm", {"n": 2708, "m": 10_562}),
])
def test_cache_key_dims_match_reference(kernel, shape):
    """The same (kernel, backend, dims) key as the reference's for the
    reference's dims; the port's segment-sum keys add D, bucketed alike."""
    assert autotune.cache_key(kernel, "cpu", shape) == jat.cache_key(kernel, "cpu", shape)
    assert autotune._key_str(autotune.cache_key(kernel, "cpu", shape)) == \
        jat._key_str(jat.cache_key(kernel, "cpu", shape))
    with_d = autotune.cache_key(kernel, "cuda", {**shape, "D": 5})
    assert dict(with_d[3])["D"] == 8


def test_cache_key_buckets_shapes_together():
    a = autotune.cache_key("segment_sum", "cpu", {"E": 900, "n": 500, "D": 1})
    b = autotune.cache_key("segment_sum", "cpu", {"E": 1024, "n": 512, "D": 1})
    c = autotune.cache_key("segment_sum", "cpu", {"E": 1025, "n": 512, "D": 1})
    assert a == b != c
    assert a[0] == autotune.TABLE_VERSION
    # the backend is part of the key: a card's winner never leaks onto the CPU
    assert a != autotune.cache_key("segment_sum", "cuda", {"E": 900, "n": 500, "D": 1})
    # and D is: the kernel's D = 1 path is tuned apart from D = 8's
    assert a != autotune.cache_key("segment_sum", "cpu", {"E": 900, "n": 500, "D": 8})


def test_grids_are_the_kernels_tiles():
    for k in autotune.SEGMENT_SUM_KERNELS:
        assert autotune.DEFAULTS[k] == {"tile": sr.TILE}
        assert [c["tile"] for c in autotune.CANDIDATES[k]] == list(sr.TILES)
    assert autotune.DEFAULTS["spmm"] == {"row_tile": 128, "col_tile": 128}
    assert autotune.CANDIDATES["spmm"] == jat.CANDIDATES["spmm"]
    for k, grid in autotune.CANDIDATES.items():  # the default is in every grid
        assert autotune.DEFAULTS[k] in grid


# -- memo hit/miss -----------------------------------------------------------


def test_winner_cache_miss_then_hit():
    shape = {"E": 4096, "n": 512, "D": 1}
    p1 = autotune.get_params("segment_sum", shape, backend="cpu")
    key = autotune.cache_key("segment_sum", "cpu", shape)
    assert autotune.CONSULTS[key] == 1  # cold consult
    p2 = autotune.get_params("segment_sum", shape, backend="cpu")
    assert p2 == p1
    assert autotune.CONSULTS[key] == 1  # memo hit: no second consult
    # a different bucket is a different entry -> one more cold consult
    autotune.get_params("segment_sum", {"E": 9000, "n": 512, "D": 1}, backend="cpu")
    assert sum(autotune.CONSULTS.values()) == 2


def test_defaults_when_sweeping_disabled():
    # CPU without REPRO_TORCH_AUTOTUNE=1: sweep_fn must NOT be invoked
    def boom(params):  # pragma: no cover - the point is it never runs
        raise AssertionError("sweep ran with sweeping disabled")

    p = autotune.get_params("segment_sum_chunked", {"R": 64, "n": 256, "D": 1}, sweep_fn=boom,
                            backend="cpu")
    assert p == autotune.DEFAULTS["segment_sum_chunked"]
    assert autotune.sweep_enabled("cuda") and not autotune.sweep_enabled("cpu")


def test_reference_env_vars_are_not_read(tmp_path, monkeypatch):
    """The reference's variables neither force a sweep nor name the
    port's table: the two tables never mix."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "ref.json"))
    assert not autotune.sweep_enabled("cpu") and autotune.cache_path() is None
    autotune.get_params("segment_sum", {"E": 256, "n": 64, "D": 1}, sweep_fn=lambda p: _zero(),
                        backend="cpu")
    assert list(tmp_path.iterdir()) == []


# -- sweep -------------------------------------------------------------------


def test_sweep_determinism_under_pinned_grid(monkeypatch):
    """With a single-candidate grid the sweep must return that candidate,
    every time, and build exactly one candidate per sweep."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    pinned = {"tile": 2048}
    autotune.set_candidates({"segment_sum": [pinned]})
    calls = []

    def make(params):
        calls.append(dict(params))
        return _zero()

    for _ in range(2):
        autotune.reset()
        p = autotune.get_params("segment_sum", {"E": 2048, "n": 256, "D": 1}, sweep_fn=make,
                                backend="cpu")
        assert p == pinned
    assert calls == [pinned, pinned]  # exactly one candidate per sweep


def test_sweep_vetoes_infeasible_candidates(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    good = {"tile": 8192}
    autotune.set_candidates({"segment_sum": [{"tile": 99999}, good]})

    def make(params):
        if params["tile"] > 8192:
            raise ValueError("a tile the kernel is not built for")
        return _zero()

    p = autotune.get_params("segment_sum", {"E": 2048, "n": 256, "D": 1}, sweep_fn=make,
                            backend="cpu")
    assert p == good
    key = autotune.cache_key("segment_sum", "cpu", {"E": 2048, "n": 256, "D": 1})
    assert [c for c, _ in autotune.TIMINGS[key]] == [good]  # the veto is not timed


def test_sweep_all_vetoed_falls_back_to_defaults(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    autotune.set_candidates({"segment_sum": [{"tile": 1}]})

    def make(params):
        raise ValueError("nope")

    p = autotune.get_params("segment_sum", {"E": 128, "n": 64, "D": 1}, sweep_fn=make,
                            backend="cpu")
    assert p == autotune.DEFAULTS["segment_sum"]


def test_sweep_picks_the_fastest_candidate(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    delay = {2048: 0.004, 4096: 0.002, 8192: 0.0}

    def make(params):
        return lambda: time.sleep(delay[params["tile"]])

    p = autotune.get_params("segment_sum_weighted", {"E": 1 << 20, "n": 1 << 16, "D": 8},
                            sweep_fn=make, backend="cpu")
    assert p == {"tile": 8192}
    key = autotune.cache_key("segment_sum_weighted", "cpu", {"E": 1 << 20, "n": 1 << 16, "D": 8})
    assert autotune.SWEEPS[key] == 1 and autotune.SWEEP_SECONDS[key] > 0
    assert len(autotune.TIMINGS[key]) == 3


def test_sweep_launches_count_apart_from_the_kernels(monkeypatch):
    """A sweep's launches go to ``SWEEP_LAUNCHES``; the kernels' own
    ``LAUNCHES`` (the main path's counts) do not move, and launches
    outside a sweep count as before."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    before = dict(sr.LAUNCHES)

    def make(params):
        return lambda: _build.launch_with_scratch(lambda: torch.zeros(()), sr.LAUNCHES,
                                                  "segment_sum")

    autotune.get_params("segment_sum", {"E": 64, "n": 8, "D": 1}, sweep_fn=make, backend="cpu")
    assert sr.LAUNCHES == before
    # each of 3 candidates: one warm call and 5 timed ones
    assert autotune.SWEEP_LAUNCHES["segment_sum"] == 3 * 6
    _build.launch_with_scratch(lambda: None, sr.LAUNCHES, "segment_sum")
    assert sr.LAUNCHES["segment_sum"] == before["segment_sum"] + 1
    sr.LAUNCHES.update(before)


def test_one_consult_and_one_sweep_per_key_across_threads(monkeypatch):
    """Six threads ask for one cold key at once: one cold consult, one
    sweep (each candidate built once), and every thread gets its winner."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    shape = {"E": 1 << 22, "n": 1 << 18, "D": 1}
    built = []

    def make(params):
        built.append(params["tile"])
        return lambda: time.sleep(0.001)

    barrier = threading.Barrier(6)
    got = [None] * 6

    def ask(i):
        barrier.wait()
        got[i] = autotune.get_params("segment_sum", shape, sweep_fn=make, backend="cpu")

    threads = [threading.Thread(target=ask, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    key = autotune.cache_key("segment_sum", "cpu", shape)
    assert autotune.CONSULTS[key] == 1 and autotune.SWEEPS[key] == 1
    assert sorted(built) == sorted(sr.TILES)
    assert all(g == got[0] for g in got) and got[0] in autotune.CANDIDATES["segment_sum"]


# -- on-disk table -----------------------------------------------------------


def test_disk_table_roundtrip(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    pinned = {"tile": 8192}
    autotune.set_candidates({"segment_sum": [pinned]})
    shape = {"E": 4096, "n": 1024, "D": 1}
    p = autotune.get_params("segment_sum", shape, sweep_fn=lambda _: _zero(), backend="cpu")
    assert p == pinned
    table = json.loads(path.read_text())
    key_s = autotune._key_str(autotune.cache_key("segment_sum", "cpu", shape))
    assert table[key_s] == pinned
    # a fresh process (reset memo) reads the winner back WITHOUT sweeping
    autotune.reset()
    autotune.set_candidates({"segment_sum": []})  # a sweep would return the defaults
    p2 = autotune.get_params("segment_sum", shape, backend="cpu")
    assert p2 == pinned


def test_disk_table_merges_and_skips_bad_entries(tmp_path, monkeypatch):
    """Another process's winners survive a write; an entry that does not
    name the kernel's parameters reads as a miss."""
    path = tmp_path / "tune.json"
    other = autotune._key_str(autotune.cache_key("spmm", "cuda", {"n": 2708, "m": 10_562}))
    bad = autotune._key_str(autotune.cache_key("segment_sum", "cpu", {"E": 8, "n": 8, "D": 1}))
    path.write_text(json.dumps({other: {"row_tile": 256, "col_tile": 256},
                                bad: {"edge_block": 512}}))
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    assert autotune.get_params("segment_sum", {"E": 8, "n": 8, "D": 1},
                               backend="cpu") == autotune.DEFAULTS["segment_sum"]
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    autotune.get_params("segment_sum", {"E": 64, "n": 8, "D": 1}, sweep_fn=lambda _: _zero(),
                        backend="cpu")
    assert json.loads(path.read_text())[other] == {"row_tile": 256, "col_tile": 256}


def test_no_disk_writes_without_env(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    autotune.get_params("segment_sum", {"E": 256, "n": 64, "D": 1}, sweep_fn=lambda _: _zero(),
                        backend="cpu")
    assert list(tmp_path.iterdir()) == []  # the table is process-local only


def test_corrupt_disk_table_is_empty_table(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    path.write_text("{not json")
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    p = autotune.get_params("segment_sum", {"E": 256, "n": 64, "D": 1}, backend="cpu")
    assert p == autotune.DEFAULTS["segment_sum"]


# -- dispatch integration ----------------------------------------------------


def _seg_consults(kernel="segment_sum"):
    return sum(v for k, v in autotune.CONSULTS.items() if k[1] == kernel)


def test_dispatch_consults_once_per_shape_bucket():
    """``ops.segment_sum`` without a tile consults the table exactly once
    per (kernel, backend, bucket): repeated dispatches are memo hits, a
    new bucket is one more cold consult."""
    rng = np.random.default_rng(0)

    def run(E, n, D=4):
        dst = torch.from_numpy(np.sort(rng.integers(0, n, E)).astype(np.int32))
        return kops.segment_sum(dst, torch.ones((E, D)), n)

    run(1000, 256)
    seg_keys = [k for k in autotune.CONSULTS if k[1] == "segment_sum"]
    assert len(seg_keys) == 1 and autotune.CONSULTS[seg_keys[0]] == 1
    assert seg_keys[0][2] == "cpu"  # the tensor's device type
    run(1000, 256)  # same bucket: still exactly one cold consult
    run(990, 250)  # same bucket after pow2 rounding: still one
    assert _seg_consults() == 1
    run(5000, 256)  # E buckets to 8192 != 1024: second cold consult
    assert _seg_consults() == 2
    run(5000, 256, D=1)  # the D = 1 path is its own key
    assert _seg_consults() == 3


def test_dispatch_result_matches_explicit_tile():
    rng = np.random.default_rng(1)
    E, n = 2000, 300
    dst = torch.from_numpy(np.sort(rng.integers(0, n, E)).astype(np.int32))
    msg = torch.from_numpy(rng.standard_normal((E, 4)).astype(np.float32))
    w = torch.from_numpy(rng.random(E).astype(np.float32))
    auto = kops.segment_sum(dst, msg, n)
    for tile in sr.TILES:
        torch.testing.assert_close(kops.segment_sum(dst, msg, n, tile=tile), auto, rtol=1e-6,
                                   atol=0)
    torch.testing.assert_close(kops.segment_sum_weighted(dst, w, msg, n, tile=2048),
                               kops.segment_sum_weighted(dst, w, msg, n), rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="tile"):
        kops.segment_sum(dst, msg, n, tile=1000)


@pytest.mark.parametrize("adaptive", [False, True])
def test_chunked_dispatch_consults_under_the_fixed_keys(adaptive):
    """Rows 3-6 consult under ``segment_sum_chunked`` /
    ``segment_sum_weighted_chunked`` with R, n and D, adaptive or not."""
    rng = np.random.default_rng(2)
    n, R = 500, 6
    lane = torch.from_numpy(np.sort(rng.integers(0, n, R * cz.CHUNK)).astype(np.int32))
    s = cz.encode_stream_adaptive(lane, hi_cap=2) if adaptive else cz.encode_stream(lane, width=1)
    msg, w = torch.rand((R * cz.CHUNK, 3)), torch.rand(R * cz.CHUNK)
    args = (s.anchors, s.deltas, s.ovf_pos, s.ovf_add)
    a = kops.segment_sum_chunked(*args, msg, n, hi=s.hi, wide=s.wide)
    b = kops.segment_sum_weighted_chunked(*args, w, msg, n, hi=s.hi, wide=s.wide)
    dims = (("D", 4), ("R", 8), ("n", 512))
    assert autotune.CONSULTS == {(1, "segment_sum_chunked", "cpu", dims): 1,
                                 (1, "segment_sum_weighted_chunked", "cpu", dims): 1}
    torch.testing.assert_close(a, kops.segment_sum_chunked(*args, msg, n, hi=s.hi, wide=s.wide,
                                                           tile=8192), rtol=1e-6, atol=0)
    torch.testing.assert_close(b, kops.segment_sum_weighted_chunked(
        *args, w, msg, n, hi=s.hi, wide=s.wide, tile=2048), rtol=1e-6, atol=0)


def test_spmm_dispatch_consults_and_takes_explicit_tiles():
    rng = np.random.default_rng(3)
    n, E = 300, 900
    src, dst = rng.integers(0, n, E), rng.integers(0, n, E)
    x = torch.from_numpy(rng.standard_normal((n, 5)).astype(np.float32))
    auto = kops.spmm_from_edges(n, src, dst, x)
    assert autotune.CONSULTS == {autotune.cache_key("spmm", "cpu", {"n": n, "m": E}): 1}
    big = kops.spmm_from_edges(n, src, dst, x, row_tile=256, col_tile=256)
    torch.testing.assert_close(big, auto, rtol=1e-5, atol=1e-5)
    assert len(autotune.CONSULTS) == 1  # explicit tiles skip the consult


def test_forced_sweep_on_the_cpu_times_the_plain_versions(monkeypatch):
    """``REPRO_TORCH_AUTOTUNE=1`` runs the real sweep factories on the
    CPU (the plain versions): a winner from the grid, no kernel launch."""
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE", "1")
    before = dict(sr.LAUNCHES)
    dst = torch.sort(torch.randint(0, 100, (3000,), dtype=torch.int32)).values
    out = kops.segment_sum(dst, torch.rand((3000, 2)), 100)
    key = autotune.cache_key("segment_sum", "cpu", {"E": 3000, "n": 100, "D": 2})
    assert autotune.SWEEPS[key] == 1 and out.shape == (100, 2)
    assert autotune._memo[key] in autotune.CANDIDATES["segment_sum"]
    assert sr.LAUNCHES == before


# -- on the card -------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run: python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


def _close(got, want):
    atol = 1e-6 * max(float(want.abs().max()) if want.numel() else 0.0, 1e-30)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [2048, 4096, 8192])
@pytest.mark.parametrize("E,n_out,D", [(1, 1, 1), (9_001, 700, 1), (100_003, 5_000, 8),
                                       (50_001, 40_000, 3), (30_011, 2_000, 64)])
def test_cuda_raw_tiles_match_plain(cuda, tile, E, n_out, D):
    gen = torch.Generator(device=cuda).manual_seed(E + D)
    dst = torch.sort(torch.randint(0, n_out + n_out // 8 + 1, (E,), generator=gen, device=cuda,
                                   dtype=torch.int32)).values
    msg = torch.randn((E, D), generator=gen, device=cuda)
    w = torch.rand(E, generator=gen, device=cuda)
    for kern, plain in ((lambda: sr.segment_sum_sorted(dst, msg, n_out, tile=tile),
                         sr.segment_sum_sorted_plain(dst, msg, n_out)),
                        (lambda: sr.segment_sum_weighted_sorted(dst, w, msg, n_out, tile=tile),
                         sr.segment_sum_weighted_sorted_plain(dst, w, msg, n_out))):
        got = kern()
        _close(got, plain)
        assert torch.equal(got, kern())  # the same bits twice


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [2048, 4096, 8192])
@pytest.mark.parametrize("layout", ["int8", "int16", "adaptive"])
@pytest.mark.parametrize("D", [1, 8, 5])
def test_cuda_chunked_tiles_match_plain(cuda, tile, layout, D):
    gen = torch.Generator(device=cuda).manual_seed(D)
    R, n = 301, 60_000
    lane = torch.sort(torch.randint(0, n + 900, (R * cz.CHUNK,), generator=gen, device=cuda,
                                    dtype=torch.int32)).values
    lane[5000:5300] = lane[5000]  # a hub run across chunk rows
    lane = torch.sort(lane).values
    if layout == "adaptive":
        s = cz.encode_stream_adaptive(lane, hi_cap=R)
    else:
        s = cz.encode_stream(lane, width=1 if layout == "int8" else 2)
    msg = torch.randn((R * cz.CHUNK, D), generator=gen, device=cuda)
    w = torch.rand(R * cz.CHUNK, generator=gen, device=cuda)
    args = (s.anchors, s.deltas, s.ovf_pos, s.ovf_add)
    kw = {"hi": s.hi, "wide": s.wide}
    for kern, plain in (
            (lambda: kops.segment_sum_chunked(*args, msg, n, tile=tile, **kw),
             sr.segment_sum_sorted_chunked_plain(*args, msg, n, **kw)),
            (lambda: kops.segment_sum_weighted_chunked(*args, w, msg, n, tile=tile, **kw),
             sr.segment_sum_weighted_chunked_plain(*args, w, msg, n, **kw))):
        got = kern()
        _close(got, plain)
        assert torch.equal(got, kern())


@pytest.mark.cuda
def test_cuda_kernel_rejects_an_unbuilt_tile(cuda):
    """A tile the library is not built for is cudaErrorInvalidValue from
    the C entry, which the launch raises on (the wrappers check first)."""
    import ctypes

    dst = torch.zeros(8, dtype=torch.int32, device=cuda)
    msg = torch.ones((8, 1), device=cuda)
    out = torch.empty((1, 1), device=cuda)
    scratch = torch.zeros(1024, dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError, match="cudaError"):
        _build.launch("segment_reduce", "repro_segment_sum_sorted",
                      [dst, msg, out, scratch, ctypes.c_longlong(8), ctypes.c_int(1),
                       ctypes.c_int(1), ctypes.c_int(1000)], cuda)
    with pytest.raises(ValueError, match="tile"):
        sr.segment_sum_sorted(dst, msg, 1, tile=1000)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [128, 256])
@pytest.mark.parametrize("n,E,D", [(300, 2000, 1), (2708, 10_562, 16), (2708, 10_562, 1433),
                                   (700, 5000, 64)])
def test_cuda_spmm_tiles_match_plain(cuda, tile, n, E, D):
    rng = np.random.default_rng(n + D)
    mask, tiles, _ = csr_spmm.tiles_from_edges(n, rng.integers(0, n, E), rng.integers(0, n, E),
                                               rng.random(E).astype(np.float32), row_tile=tile,
                                               col_tile=tile)
    mask[0, 0] = 0  # a nonzero tile masked off
    m, a = torch.from_numpy(mask).to(cuda), torch.from_numpy(tiles).to(cuda)
    x = torch.randn((n, D), generator=torch.Generator(device=cuda).manual_seed(1), device=cuda)
    got = csr_spmm.block_spmm(m, a, x)
    torch.testing.assert_close(got, csr_spmm.block_spmm_plain(m, a, x), rtol=1e-5, atol=1e-4)
    assert torch.equal(got, csr_spmm.block_spmm(m, a, x))


@pytest.mark.cuda
def test_cuda_sweeps_pick_a_candidate_off_the_main_counts(cuda):
    """On the card the first consult of each key sweeps: the winner is a
    grid candidate, the sweep's launches count in ``SWEEP_LAUNCHES`` and
    not in ``LAUNCHES``, and a second call of the same bucket is a memo
    hit that launches once, counted."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    E, n = 200_003, 20_000
    dst = torch.sort(torch.randint(0, n, (E,), generator=gen, device=cuda,
                                   dtype=torch.int32)).values
    msg = torch.rand((E, 8), generator=gen, device=cuda)
    before, spmm_before = dict(sr.LAUNCHES), dict(csr_spmm.LAUNCHES)
    with _build.counting_into({}) as side:  # the first call's own launch, set aside
        got = kops.segment_sum(dst, msg, n)
    key = autotune.cache_key("segment_sum", "cuda", {"E": E, "n": n, "D": 8})
    assert autotune.SWEEPS[key] == 1 and side == {"segment_sum": 1}
    assert sr.LAUNCHES == before
    assert autotune.SWEEP_LAUNCHES["segment_sum"] == 3 * 6
    assert autotune._memo[key] in autotune.CANDIDATES["segment_sum"]
    _close(got, sr.segment_sum_sorted_plain(dst, msg, n))
    kops.segment_sum(dst, msg, n)
    assert sr.LAUNCHES["segment_sum"] == before["segment_sum"] + 1 and autotune.SWEEPS[key] == 1
    x = torch.rand((2708, 16), device=cuda)
    rng = np.random.default_rng(0)
    kops.spmm_from_edges(2708, rng.integers(0, 2708, 10_562), rng.integers(0, 2708, 10_562), x)
    assert csr_spmm.LAUNCHES["block_spmm"] == spmm_before["block_spmm"] + 1
    assert autotune.SWEEP_LAUNCHES["block_spmm"] == 2 * 6
