"""The port's segment-sum wrappers against the JAX reference kernels.

On the CPU the wrappers run their plain PyTorch versions; the reference
runs its Pallas kernels in interpret mode through ``repro.kernels.ops``.
Both get the same numpy inputs: ragged shapes, dst ascending with
out-of-range pad entries.  Tolerance rtol 1e-5, atol 1e-6: the reference
sums in 512-edge one-hot blocks, the plain version with ``index_add_``,
so the float32 summation order differs.

Tests marked ``cuda`` hold the CUDA kernels against the plain versions on
a GPU; they skip on a machine without one.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch._device import resolve
from repro_torch.kernels import _build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segment_reduce as sr

SRC = Path(__file__).resolve().parents[1] / "src"


def _inputs(E, n_out, D, seed=0):
    rng = np.random.default_rng(seed + 7 * E + 13 * n_out + D)
    dst = np.sort(rng.integers(0, n_out + max(1, n_out // 7) + 1, size=E)).astype(np.int32)
    msg = rng.standard_normal((E, D)).astype(np.float32)
    w = rng.random(E).astype(np.float32)
    return dst, msg, w


SHAPES = [(E, n, D) for E in (1, 777, 2051) for n in (1, 130, 1000) for D in (1, 3, 8)]


# Lanes at the corners of the kernels' partition into tiles, groups and
# runs: (dst int32 ascending, n_out).  ``big`` sizes them to span many
# 4096-slot tiles (about 10^6 slots, a row of 3 * 10^5) for the card.
EDGE_CASES = ["one_row", "hub", "empty_rows", "all_pads", "e1", "negative"]


def edge_case(name: str, big: bool = False, seed: int = 0):
    rng = np.random.default_rng(seed)
    E, hub = (1_000_000, 300_000) if big else (4_000, 3_000)
    if name == "one_row":  # every slot in one row
        dst, n_out = np.full(E, 5), 9
    elif name == "hub":  # a hub row among rows of 1-3 edges
        small = np.repeat(np.arange((E - hub) // 2), rng.integers(1, 4, (E - hub) // 2))
        n_out = int(small[-1]) + 10
        dst = np.sort(np.concatenate([small, np.full(hub, n_out // 3)]))
    elif name == "empty_rows":  # empty before the first key, between keys, after the last
        keys = np.sort(rng.choice(np.arange(100, 8 * E, 7), E // 4, replace=False))
        dst, n_out = np.repeat(keys, rng.integers(1, 7, keys.size)), 8 * E + 50
    elif name == "all_pads":  # every slot at or past n_out
        dst, n_out = np.concatenate([np.full(E // 2, 50), np.full(E - E // 2, 61)]), 50
    elif name == "e1":
        dst, n_out = np.array([3]), 10
    else:  # negative keys first, then ordinary rows
        dst = np.sort(np.concatenate([rng.integers(-9, 0, E // 8), rng.integers(0, E // 4, E)]))
        n_out = E // 4
    return dst.astype(np.int32), n_out


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("D", [1, 3])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_segment_sum_partition_edge_cases(case, D, weighted):
    """The partition's corners, plain version against the reference's
    kernel and the float64 oracle."""
    dst, n_out = edge_case(case)
    rng = np.random.default_rng(D)
    msg = rng.standard_normal((dst.size, D)).astype(np.float32)
    w = rng.random(dst.size).astype(np.float32)
    td, tm, tw = torch.from_numpy(dst), torch.from_numpy(msg), torch.from_numpy(w)
    if weighted:
        got = tops.segment_sum_weighted(td, tw, tm, n_out).numpy()
        want = np.asarray(jops.segment_sum_weighted(
            jnp.asarray(dst), jnp.asarray(w), jnp.asarray(msg), n_out))
        oracle = tref.segment_sum_weighted_sorted_ref(td, tw, tm, n_out).numpy()
    else:
        got = tops.segment_sum(td, tm, n_out).numpy()
        want = np.asarray(jops.segment_sum(jnp.asarray(dst), jnp.asarray(msg), n_out))
        oracle = tref.segment_sum_sorted_ref(td, tm, n_out).numpy()
    assert got.shape == (n_out, D)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("E,n_out,D", SHAPES)
def test_segment_sum_matches_reference(E, n_out, D):
    dst, msg, _ = _inputs(E, n_out, D)
    got = tops.segment_sum(torch.from_numpy(dst), torch.from_numpy(msg), n_out).numpy()
    want = np.asarray(jops.segment_sum(jnp.asarray(dst), jnp.asarray(msg), n_out))
    keep = dst < n_out
    oracle = np.asarray(jref.segment_sum_sorted_ref(
        jnp.asarray(dst[keep]), jnp.asarray(msg[keep]), n_out))
    assert got.shape == (n_out, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        got, tref.segment_sum_sorted_ref(torch.from_numpy(dst), torch.from_numpy(msg),
                                         n_out).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("E,n_out,D", SHAPES)
def test_segment_sum_weighted_matches_reference(E, n_out, D):
    dst, msg, w = _inputs(E, n_out, D, seed=1)
    got = tops.segment_sum_weighted(
        torch.from_numpy(dst), torch.from_numpy(w), torch.from_numpy(msg), n_out).numpy()
    want = np.asarray(jops.segment_sum_weighted(
        jnp.asarray(dst), jnp.asarray(w), jnp.asarray(msg), n_out))
    oracle = tref.segment_sum_weighted_sorted_ref(
        torch.from_numpy(dst), torch.from_numpy(w), torch.from_numpy(msg), n_out).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, oracle, rtol=1e-5, atol=1e-6)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    dst, msg, w = _inputs(300, 40, 2)
    before = dict(sr.LAUNCHES)
    a = sr.segment_sum_sorted(torch.from_numpy(dst), torch.from_numpy(msg), 40)
    b = sr.segment_sum_weighted_sorted(
        torch.from_numpy(dst), torch.from_numpy(w), torch.from_numpy(msg), 40)
    assert sr.LAUNCHES == before
    torch.testing.assert_close(
        a, sr.segment_sum_sorted_plain(torch.from_numpy(dst), torch.from_numpy(msg), 40))
    assert b.shape == (40, 2)


@pytest.mark.parametrize("bad", ["dst_dtype", "msg_rank", "w_shape", "noncontig"])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    dst, msg, w = (torch.from_numpy(a) for a in _inputs(64, 10, 4))
    if bad == "dst_dtype":
        dst = dst.long()
    elif bad == "msg_rank":
        msg = msg[:, 0]
    elif bad == "w_shape":
        w = w[:-1]
    else:
        msg = msg.T.contiguous().T
    with pytest.raises((TypeError, ValueError)):
        sr.segment_sum_weighted_sorted(dst, w, msg, 10)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler means an error, never a quiet fallback."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()


def test_cuda_request_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve(None)
    with pytest.raises(RuntimeError):
        resolve("cuda")
    assert resolve("cpu").type == "cpu"


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'repro' or k.startswith('repro.')\n"
        "       or k == 'jax' and sys.modules[k] is not None]\n"
        "assert not bad, bad\n"
        "print('ok', len([k for k in sys.modules if k.startswith('repro_torch')]))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin"},
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run: python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("E,n_out,D", [(1, 1, 1), (2051, 1000, 8), (100_003, 5_000, 64)])
def test_cuda_kernels_match_plain(cuda, E, n_out, D):
    dst, msg, w = (torch.from_numpy(a).to(cuda) for a in _inputs(E, n_out, D))
    before = dict(sr.LAUNCHES)
    a = sr.segment_sum_sorted(dst, msg, n_out)
    b = sr.segment_sum_weighted_sorted(dst, w, msg, n_out)
    torch.cuda.synchronize()
    assert sr.LAUNCHES["segment_sum"] == before["segment_sum"] + 1
    assert sr.LAUNCHES["segment_sum_weighted"] == before["segment_sum_weighted"] + 1
    for got, want in ((a, sr.segment_sum_sorted_plain(dst, msg, n_out)),
                      (b, sr.segment_sum_weighted_sorted_plain(dst, w, msg, n_out))):
        atol = 1e-6 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)
    # a fixed summation order: the same bits on every call
    assert torch.equal(a, sr.segment_sum_sorted(dst, msg, n_out))
    assert torch.equal(b, sr.segment_sum_weighted_sorted(dst, w, msg, n_out))


@pytest.mark.cuda
@pytest.mark.parametrize("D", [1, 8, 64])
@pytest.mark.parametrize("case", EDGE_CASES)
def test_cuda_kernels_partition_edge_cases(cuda, case, D):
    """The edge cases at sizes that span many tiles, held against the
    float64 oracle: the plain version's atomics sum a row of 3 * 10^5
    terms in one float32 chain in no fixed order, whose error nears the
    tolerance itself.  Two calls give the same bits."""
    dst, n_out = edge_case(case, big=True)
    if D == 64:  # a quarter of the slots keeps the messages at 256 MB
        dst, n_out = edge_case(case, big=True)[0][::4].copy(), n_out
    gen = torch.Generator(device=cuda).manual_seed(D)
    dst = torch.from_numpy(dst).to(cuda)
    msg = torch.randn((dst.numel(), D), generator=gen, device=cuda)
    w = torch.rand(dst.numel(), generator=gen, device=cuda)
    for kern, ref in ((lambda: sr.segment_sum_sorted(dst, msg, n_out),
                       lambda: tref.segment_sum_sorted_ref(dst, msg, n_out)),
                      (lambda: sr.segment_sum_weighted_sorted(dst, w, msg, n_out),
                       lambda: tref.segment_sum_weighted_sorted_ref(dst, w, msg, n_out))):
        got = kern()
        want = ref().float()
        atol = 1e-6 * max(float(want.abs().max()), 1e-30)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=atol)
        assert torch.equal(got, kern())
