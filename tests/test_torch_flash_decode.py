"""The port's flash-decode attention against the JAX reference.

On the CPU the wrapper runs its plain PyTorch version; the reference runs
its Pallas kernel in interpret mode through ``repro.kernels.ops``, which
pads S to whole 512-key blocks (the port takes any S).  Both get the same
numpy inputs from a seed.  Tolerances are the reference's own
(``tests/test_kernels.py:214-241``): float32 rtol 2e-5, bf16 rtol 3e-2,
both atol 2e-2 (float32 softmax sums in another order; in bf16 both round
a float32 result to bf16); the short-length case rtol 1e-5, atol 1e-5.

Tests marked ``cuda`` hold the CUDA kernel against its plain version on a
GPU; they skip on a machine without one.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import _build
from repro_torch.kernels import csr_spmm as tsp
from repro_torch.kernels import flash_decode as fd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def inputs(BH, Q, S, d, seed, lengths=None):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, Q, d)).astype(np.float32)
    k = rng.standard_normal((BH, S, d)).astype(np.float32)
    v = rng.standard_normal((BH, S, d)).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(S // 2, S + 1, size=BH)
    return q, k, v, np.asarray(lengths, np.int32)


def both(q, k, v, lengths, dtype):
    """The port's ``ops.flash_decode_attn`` and the reference's on the same
    inputs in ``dtype``, both as float32 numpy arrays."""
    jd, td = DTYPES[dtype]
    got = tops.flash_decode_attn(*(torch.from_numpy(x).to(td) for x in (q, k, v)),
                                 torch.from_numpy(lengths))
    want = jops.flash_decode_attn(*(jnp.asarray(x, dtype=jd) for x in (q, k, v)),
                                  jnp.asarray(lengths))
    assert got.dtype == td and tuple(got.shape) == q.shape
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.fixture
def no_kernel(monkeypatch):
    """Any attempt to reach a CUDA kernel fails the test."""

    def refuse(*args, **kwargs):
        raise AssertionError("a CPU tensor reached the CUDA kernel")

    monkeypatch.setattr(_build, "launch", refuse)


@pytest.mark.parametrize("BH,Q,S,d", [(4, 8, 1024, 64), (2, 4, 2048, 128), (1, 8, 640, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_matches_reference(BH, Q, S, d, dtype, no_kernel):
    q, k, v, lengths = inputs(BH, Q, S, d, seed=4)
    got, want = both(q, k, v, lengths, dtype)
    rtol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got, want, rtol=rtol, atol=2e-2)
    if dtype == "float32":  # and the float64 oracle, as tightly
        oracle = tref.flash_decode_ref(*(torch.from_numpy(x) for x in (q, k, v, lengths)))
        np.testing.assert_allclose(got, oracle.numpy(), rtol=2e-5, atol=2e-5)


def test_flash_decode_short_length(no_kernel):
    """Length 7 of 2048: the masked keys contribute nothing."""
    q, k, v, lengths = inputs(1, 8, 2048, 64, seed=5, lengths=[7])
    got, want = both(q, k, v, lengths, "float32")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    alone, _ = both(q, k[:, :7], v[:, :7], lengths, "float32")
    np.testing.assert_allclose(got, alone, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_length_zero_row(dtype, no_kernel):
    """A row of length 0 gives 0, as the reference's kernel (``ops``) gives;
    its oracle gives NaN there (a softmax over nothing), and so does the
    port's."""
    q, k, v, lengths = inputs(4, 8, 640, 64, seed=6, lengths=[0, 1, 7, 640])
    got, want = both(q, k, v, lengths, dtype)
    assert not np.isnan(want).any() and np.all(want[0] == 0.0)
    np.testing.assert_array_equal(got[0], np.zeros_like(got[0]))
    rtol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got, want, rtol=rtol, atol=2e-2)
    oracle = tref.flash_decode_ref(*(torch.from_numpy(x) for x in (q, k, v, lengths))).numpy()
    joracle = np.asarray(jref.flash_decode_ref(*(jnp.asarray(x) for x in (q, k, v, lengths))))
    assert np.isnan(oracle[0]).all() and np.isnan(joracle[0]).all()


@pytest.mark.parametrize("S", [640, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_decode_any_S(S, dtype, no_kernel):
    """S not a multiple of the reference's 512-key block: the port takes it
    unpadded, the reference pads with zeros."""
    q, k, v, lengths = inputs(3, 4, S, 32, seed=S)
    lengths[0] = S  # one row over every key
    got, want = both(q, k, v, lengths, dtype)
    rtol = 2e-5 if dtype == "float32" else 3e-2
    np.testing.assert_allclose(got, want, rtol=rtol, atol=2e-2)


def test_flash_decode_head_dim_12(no_kernel):
    """d = 12, the REDUCED smollm head."""
    q, k, v, lengths = inputs(5, 1, 100, 12, seed=12)
    got, want = both(q, k, v, lengths, "float32")
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-2)


def test_flash_decode_f32_query_bf16_cache(no_kernel):
    """An f32 query against a bf16 cache (the reference's ``generate`` with
    f32 weights): the cache is read exactly as bf16 widened to f32."""
    q, k, v, lengths = inputs(4, 3, 300, 64, seed=8)
    got = tops.flash_decode_attn(torch.from_numpy(q), torch.from_numpy(k).bfloat16(),
                                 torch.from_numpy(v).bfloat16(), torch.from_numpy(lengths))
    want = jops.flash_decode_attn(jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
                                  jnp.asarray(v, jnp.bfloat16), jnp.asarray(lengths))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def cache_inputs(B, S_max, n_kv, Q, d, seed, dtype=torch.float32, device="cpu"):
    """q (B, n_kv, Q, d), a layer's cache slices (B, S_max, n_kv, d) cut
    from 5-D caches on ``device`` (as ``decode_step`` passes them), and
    lengths (B,)."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn((B, n_kv, Q, d), generator=g).to(device, dtype)
    cache = torch.randn((2, 3, B, S_max, n_kv, d), generator=g).to(device, dtype)
    lengths = torch.randint(1, S_max + 1, (B,), generator=g, dtype=torch.int32).to(device)
    return q, cache[0, 1], cache[1, 1], lengths


@pytest.mark.parametrize("n_kv,Q,d", [(5, 3, 64), (2, 8, 128), (4, 9, 128)])
def test_flash_decode_cache_equals_contiguous(n_kv, Q, d, no_kernel):
    """The strided entry on a (B, S_max, n_kv, d) cache slice equals the
    contiguous call on the reference's transposed (B * n_kv, S_max, d)
    copy, with each sequence's length repeated over its kv heads."""
    B, S_max = 2, 300
    q, kc, vc, lengths = cache_inputs(B, S_max, n_kv, Q, d, seed=Q)
    assert kc.storage_offset() > 0  # a slice of the cache, read where it lies
    got = fd.flash_decode_cache(q, kc, vc, lengths)
    kf = kc.permute(0, 2, 1, 3).reshape(B * n_kv, S_max, d)
    vf = vc.permute(0, 2, 1, 3).reshape(B * n_kv, S_max, d)
    want = fd.flash_decode(q.reshape(B * n_kv, Q, d), kf, vf, lengths.repeat_interleave(n_kv))
    assert tuple(got.shape) == (B, n_kv, Q, d)
    torch.testing.assert_close(got, want.reshape(B, n_kv, Q, d), rtol=0, atol=0)
    jwant = jops.flash_decode_attn(jnp.asarray(q.reshape(B * n_kv, Q, d).numpy()),
                                   jnp.asarray(kf.numpy()), jnp.asarray(vf.numpy()),
                                   jnp.asarray(lengths.repeat_interleave(n_kv).numpy()))
    np.testing.assert_allclose(got.reshape(B * n_kv, Q, d).numpy(), np.asarray(jwant),
                               rtol=2e-5, atol=2e-2)


def test_flash_decode_refuses_what_the_kernel_does_not_take():
    q = torch.zeros((2, 4, 64))
    k = torch.zeros((2, 32, 64))
    lens = torch.full((2,), 32, dtype=torch.int32)
    with pytest.raises(TypeError):  # k and v in two dtypes
        fd.flash_decode(q, k, k.bfloat16(), lens)
    with pytest.raises(TypeError):  # float16
        fd.flash_decode(q.half(), k.half(), k.half(), lens)
    with pytest.raises(TypeError):  # float lengths
        fd.flash_decode(q, k, k, lens.float())
    with pytest.raises(ValueError):  # d > 256
        fd.flash_decode(torch.zeros((2, 4, 264)), torch.zeros((2, 8, 264)),
                        torch.zeros((2, 8, 264)), lens)
    with pytest.raises(ValueError):  # Q > 16
        fd.flash_decode(torch.zeros((2, 17, 64)), k, k, lens)
    with pytest.raises(ValueError):  # head dims disagree
        fd.flash_decode(torch.zeros((2, 4, 32)), k, k, lens)
    with pytest.raises(ValueError):  # rows disagree
        fd.flash_decode(q, k[:1], k[:1], lens)
    with pytest.raises(ValueError):  # operands on two devices
        fd.flash_decode(q, k.to("meta"), k.to("meta"), lens)
    with pytest.raises(ValueError):  # cache of the wrong rank
        fd.flash_decode_cache(q[:, None], k, k, lens)


def test_flash_decode_counts_no_launch_on_the_cpu(no_kernel):
    fd.reset_launches()
    q, k, v, lengths = inputs(2, 2, 64, 16, seed=9)
    fd.flash_decode(*(torch.from_numpy(x) for x in (q, k, v, lengths)))
    fd.flash_decode_cache(*cache_inputs(2, 64, 2, 3, 16, seed=9))
    assert fd.LAUNCHES == {"flash_decode": 0, "flash_decode_tma": 0, "flash_decode_cpasync": 0}


def _strides(t):
    """(batch, position, head) strides of a (B, S, n_kv, d) cache slice or
    of a (BH, S, d) row tensor (head stride 0), as the wrapper passes them."""
    return (t.stride(0), t.stride(1), t.stride(2) if t.dim() == 4 else 0)


def _sizes(t):
    return (t.shape[0], t.shape[1], t.shape[2] if t.dim() == 4 else 1)


def _unaligned(shape, dtype):
    """A contiguous tensor of ``shape`` whose base is one element past a
    16-byte boundary."""
    n = 1
    for x in shape:
        n *= x
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


ROUTE_CASES = {
    # name: (k, expected TMA route)
    "rows_f32_d64": (lambda: torch.zeros((3, 100, 64)), True),
    "rows_bf16_d64": (lambda: torch.zeros((3, 100, 64), dtype=torch.bfloat16), True),
    "cache_slice_bf16_d64": (lambda: torch.zeros((2, 3, 2, 300, 5, 64),
                                                 dtype=torch.bfloat16)[0, 1], True),
    "cache_slice_f32_d128": (lambda: torch.zeros((2, 3, 2, 64, 4, 128))[1, 2], True),
    "bf16_d12": (lambda: torch.zeros((5, 100, 12), dtype=torch.bfloat16), False),  # 24-byte rows
    "f32_d12": (lambda: torch.zeros((5, 100, 12)), True),  # 48-byte rows
    "bf16_d8_row_stride_24_bytes": (
        lambda: torch.zeros((2, 50, 12), dtype=torch.bfloat16)[..., :8], False),
    "unaligned_base": (lambda: _unaligned((2, 50, 64), torch.bfloat16), False),
    "one_batch_row_odd_batch_stride": (
        lambda: torch.zeros(4000).as_strided((1, 50, 64), (3, 64, 1)), True),
    "no_positions": (lambda: torch.zeros((2, 0, 64)), False),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_tma_route_rule(case):
    """The TMA route takes a cache whose row bytes and used strides are
    multiples of 16 bytes and whose base is 16-byte aligned; strides of
    dimensions of size 1 do not count."""
    make, want = ROUTE_CASES[case]
    k = make()
    assert fd.tma_route(k, k, _sizes(k), _strides(k), _strides(k)) is want
    if want:  # a v that is not aligned sends the call to the cp.async route
        v = _unaligned(tuple(k.shape), k.dtype)
        assert fd.tma_route(k, v, _sizes(k), _strides(k), _strides(v)) is False


def test_workspace_sizes():
    """The flash partials take Q * (d + 2) floats per row and split, none
    with one split (long_500k's 5 rows of 52 splits: 206 KB); the SpMM
    workspace is one slot per tile, from the shapes alone (gcn-cora's
    22 x 22 tiles: 63.7 MB)."""
    assert fd.workspace_floats(5, 1, 3, 64) == 0
    assert fd.workspace_floats(5, 52, 3, 64) == 5 * 52 * 3 * 66 == 51_480
    assert fd.workspace_floats(160, 7, 3, 64) == 160 * 7 * 3 * 66
    assert tsp.SLOT_BYTES == 4 * 132 + 8 * 128 * 128
    assert tsp.workspace_bytes(22, 22) == 484 * 131_600 == 63_694_400
    assert tsp.workspace_bytes(0, 5) == 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run: python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


def _tol(dtype, want):
    # float32: the kernel's split sums against cuBLAS float32 products;
    # bf16: both round a float32 result to bf16
    r = 2e-5 if dtype == torch.float32 else 1e-2
    return {"rtol": r, "atol": r * float(want.float().abs().max())}


@pytest.mark.cuda
@pytest.mark.parametrize("BH,Q,S,d", [(4, 8, 1024, 64), (2, 4, 2048, 128), (1, 8, 640, 64),
                                      (4, 3, 1000, 64), (5, 1, 100, 12)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_matches_plain(cuda, BH, Q, S, d, dtype):
    q, k, v, lengths = inputs(BH, Q, S, d, seed=S + d)
    lengths[0] = 0
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in (q, k, v))
    lens = torch.from_numpy(lengths).to(cuda)
    fd.reset_launches()
    got = fd.flash_decode(q, k, v, lens)
    torch.cuda.synchronize()
    assert fd.LAUNCHES["flash_decode"] == 1
    want = fd.flash_decode_plain(q, k, v, lens)
    torch.testing.assert_close(got, want, **_tol(dtype, want))
    assert bool((got[0] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n_kv,Q,d", [(5, 3, 64), (2, 8, 128), (4, 9, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_cache_matches_plain(cuda, n_kv, Q, d, dtype):
    q, kc, vc, lengths = cache_inputs(3, 2000, n_kv, Q, d, seed=d, dtype=dtype, device=cuda)
    got = fd.flash_decode_cache(q, kc, vc, lengths)
    torch.cuda.synchronize()
    want = fd.flash_decode_cache(q.cpu(), kc.cpu(), vc.cpu(), lengths.cpu())
    torch.testing.assert_close(got.cpu(), want, **_tol(dtype, want))


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype,route", [(64, torch.bfloat16, "tma"), (128, torch.float32, "tma"),
                                           (12, torch.float32, "tma"),
                                           (12, torch.bfloat16, "cpasync"),
                                           (256, torch.float32, "tma")])
@pytest.mark.parametrize("Q", [1, 3, 9])
def test_cuda_flash_decode_routes_match_plain(cuda, d, dtype, route, Q):
    """Each route against the plain version, with lengths 0, 1 and 7
    beside long rows that take several splits; the call counts on its
    route and leaves the row counters at zero."""
    q, k, v, lengths = inputs(5, Q, 20_000, d, seed=d + Q)
    lengths[:3] = [0, 1, 7]
    q, k, v = (torch.from_numpy(x).to(cuda, dtype) for x in (q, k, v))
    lens = torch.from_numpy(lengths).to(cuda)
    fd.reset_launches()
    got = fd.flash_decode(q, k, v, lens)
    torch.cuda.synchronize()
    assert fd.LAUNCHES["flash_decode"] == fd.LAUNCHES["flash_decode_" + route] == 1
    want = fd.flash_decode_plain(q, k, v, lens)
    torch.testing.assert_close(got, want, **_tol(dtype, want))
    assert bool((got[0] == 0).all())
    assert all(int(buf.abs().sum()) == 0 for key, buf in _build._SCRATCH.items()
               if key[0] == "flash_counters")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_cache_takes_tma_and_repeats_bits(cuda, dtype):
    """smollm-360m's cache slice (n_kv = 5, Q = 3, d = 64) takes the TMA
    route, and two calls give the same bits (the row's last block merges
    the partials in split order, whichever block comes last)."""
    q, kc, vc, lengths = cache_inputs(2, 30_000, 5, 3, 64, seed=3, dtype=dtype, device=cuda)
    fd.reset_launches()
    a = fd.flash_decode_cache(q, kc, vc, lengths)
    b = fd.flash_decode_cache(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert fd.LAUNCHES["flash_decode_tma"] == 2
    assert torch.equal(a, b)
    want = fd.flash_decode_cache_plain(q, kc, vc, lengths)
    torch.testing.assert_close(a, want, **_tol(dtype, want))
