"""The port's GNN kernels (fanout aggregate, block SpMM) against the JAX reference.

On the CPU the wrappers run their plain PyTorch versions; the reference
runs its Pallas kernels in interpret mode through ``repro.kernels.ops``
(padded there: the fanout batch to 8, x to whole tiles; ragged here).
Both get the same numpy inputs from a seed.  Tolerances are the
reference's own (``tests/test_kernels.py``): fanout rtol 1e-6, atol 1e-6
(float32 sums over K in another order); SpMM rtol 1e-5, atol 1e-4
(float32 products over up to 384 columns in another order).  The tile
builder is compared bit for bit.  The reference's SpMM side stays at
n <= 512, since interpret mode is slow.

Tests marked ``cuda`` hold the CUDA kernels against their plain versions
on a GPU; they skip on a machine without one.
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import csr_spmm as jsp
from repro.kernels import ops as jops
from repro_torch.kernels import csr_spmm as tsp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import segment_reduce as sr

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def fanout_inputs(B, K, D, kind, seed):
    """Features and a (B, K) mask: ``bool`` as the reference's test makes
    it (column 0 always valid), ``fractional`` float values in [0, 1)
    with zeros, ``empty`` the bool mask with every third bag empty."""
    rng = np.random.default_rng(seed)
    feats = rng.standard_normal((B, K, D)).astype(np.float32)
    mask = (rng.random((B, K)) < 0.7).astype(np.float32)
    mask[:, 0] = 1.0
    if kind == "fractional":
        mask = (mask * rng.random((B, K))).astype(np.float32)
    elif kind == "empty":
        mask[::3] = 0.0
    return feats, mask


FANOUT_SHAPES = [(16, 10, 64), (5, 25, 128), (1, 15, 602), (13, 10, 6), (9, 3, 1)]


@pytest.mark.parametrize("op", ["mean", "sum", "max"])
@pytest.mark.parametrize("kind", ["bool", "fractional", "empty"])
@pytest.mark.parametrize("B,K,D", FANOUT_SHAPES)
def test_fanout_matches_reference(op, kind, B, K, D):
    feats, mask = fanout_inputs(B, K, D, kind, seed=B * 100 + K + D)
    got = tops.fanout_aggregate(_t(feats), _t(mask), op)
    want = np.asarray(jops.fanout_aggregate(jnp.asarray(feats), jnp.asarray(mask), op))
    assert got.dtype == torch.float32 and tuple(got.shape) == (B, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    oracle = tref.fanout_aggregate_ref(_t(feats), _t(mask), op).numpy()
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-6, atol=1e-6)


def test_fanout_empty_bags_and_mask_sum():
    """An empty bag gives 0 under sum and mean and finfo(float32).min
    under max (not -inf); mean divides by the mask's sum, not by the
    count of nonzero entries."""
    feats = np.ones((3, 4, 2), np.float32)
    mask = np.array([[0, 0, 0, 0], [0.5, 0.5, 0, 0], [0.25, 0.25, 0.25, 0.25]], np.float32)
    for op in ("sum", "mean", "max"):
        got = tops.fanout_aggregate(_t(feats), _t(mask), op).numpy()
        want = np.asarray(jops.fanout_aggregate(jnp.asarray(feats), jnp.asarray(mask), op))
        np.testing.assert_array_equal(got, want)
    mean = tops.fanout_aggregate(_t(feats), _t(mask), "mean").numpy()
    np.testing.assert_array_equal(mean[:, 0], [0.0, 1.0, 1.0])
    mx = tops.fanout_aggregate(_t(feats), _t(mask), "max").numpy()
    assert mx[0, 0] == np.finfo(np.float32).min


def test_fanout_bool_mask_through_ops():
    feats, mask = fanout_inputs(6, 5, 8, "bool", seed=4)
    got = tops.fanout_aggregate(_t(feats), _t(mask > 0), "mean")
    np.testing.assert_array_equal(got.numpy(), tops.fanout_aggregate(_t(feats), _t(mask)).numpy())


@pytest.mark.parametrize("n,E,vals", [
    (256, 2000, False), (300, 5000, True), (1, 3, False), (130, 900, True), (77, 400, False),
])
def test_tiles_from_edges_bit_identical(n, E, vals):
    rng = np.random.default_rng(n + E)
    src = rng.integers(0, n, size=E)
    dst = rng.integers(0, n, size=E)
    src[: E // 4] = src[0]  # duplicate (dst, src) pairs must accumulate
    dst[: E // 4] = dst[0]
    v = rng.standard_normal(E).astype(np.float32) if vals else None
    got = tsp.tiles_from_edges(n, src, dst, v)
    want = jsp.tiles_from_edges(n, src, dst, v, row_tile=128, col_tile=128)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    assert got[2] == want[2]
    assert got[0].dtype == np.int32 and got[1].dtype == np.float32


@pytest.mark.parametrize("n,E,D", [(256, 2000, 64), (300, 5000, 128), (300, 700, 1),
                                   (512, 3000, 16)])
def test_spmm_from_edges_matches_reference_and_dense(n, E, D):
    rng = np.random.default_rng(6 + n + D)
    src = rng.integers(0, n, size=E)
    dst = rng.integers(0, n, size=E)
    x = rng.standard_normal((n, D)).astype(np.float32)
    got = tops.spmm_from_edges(n, src, dst, _t(x))
    assert got.dtype == torch.float32 and tuple(got.shape) == (n, D)
    want = np.asarray(jops.spmm_from_edges(n, src, dst, jnp.asarray(x), row_tile=128,
                                           col_tile=128))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    a = np.zeros((n, n), dtype=np.float32)
    np.add.at(a, (dst, src), 1.0)
    np.testing.assert_allclose(got.numpy(), a @ x, rtol=1e-5, atol=1e-4)


def test_spmm_skips_masked_tile_like_the_kernel():
    """A nonzero tile whose mask is forced to 0 contributes nothing, as in
    the reference's kernel (``ops.spmm``); the reference's oracle
    ``block_spmm_ref`` and its twin here read it anyway.  A row of all
    empty tiles gives zeros."""
    rng = np.random.default_rng(11)
    n, E, D = 384, 3000, 32
    src = rng.integers(0, n, size=E)
    dst = rng.integers(0, 256, size=E)  # row tile 2 has no edges
    x = rng.standard_normal((n - 50, D)).astype(np.float32)  # rows past n_x read as zero
    mask, tiles, _ = tsp.tiles_from_edges(n, src, dst)
    assert mask[1, 0] == 1 and not mask[2].any()
    mask[1, 0] = 0
    got = tops.spmm(_t(mask), _t(tiles), _t(x)).numpy()
    want = np.asarray(jops.spmm(jnp.asarray(mask), jnp.asarray(tiles), jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert not got[256:].any()
    xp = np.zeros((n, D), np.float32)
    xp[: n - 50] = x
    oracle = tref.block_spmm_ref(_t(mask), _t(tiles), _t(xp)).numpy()
    assert np.abs(oracle[128:256] - got[128:256]).max() > 1e-2  # the oracle reads the tile
    np.testing.assert_allclose(got[:128], oracle[:128], rtol=1e-5, atol=1e-4)


def test_cpu_wrappers_take_plain_and_count_no_launch():
    feats, mask = fanout_inputs(4, 3, 8, "bool", seed=1)
    before_f, before_s = sr.LAUNCHES["fanout_aggregate"], tsp.LAUNCHES["block_spmm"]
    sr.fanout_aggregate(_t(feats), _t(mask), "sum")
    m, a, _ = tsp.tiles_from_edges(130, np.arange(130), np.arange(130)[::-1])
    tsp.block_spmm(_t(m), _t(a), torch.ones((130, 2)))
    assert sr.LAUNCHES["fanout_aggregate"] == before_f
    assert tsp.LAUNCHES["block_spmm"] == before_s


@pytest.mark.parametrize("bad", [
    "fanout_op", "fanout_dtype", "fanout_mask_shape", "fanout_k0", "spmm_mask_dtype",
    "spmm_x_rows", "spmm_tiles_dim", "spmm_strided", "spmm_tile_size",
])
def test_wrappers_reject_what_the_kernel_does_not_take(bad):
    f = torch.zeros((4, 3, 8))
    m = torch.ones((4, 3))
    tm = torch.ones((2, 2), dtype=torch.int32)
    tiles = torch.zeros((2, 2, 128, 128))
    x = torch.zeros((256, 4))
    calls = {
        "fanout_op": lambda: sr.fanout_aggregate(f, m, "min"),
        "fanout_dtype": lambda: sr.fanout_aggregate(f.double(), m),
        "fanout_mask_shape": lambda: sr.fanout_aggregate(f, m[:, :2].contiguous()),
        "fanout_k0": lambda: sr.fanout_aggregate(f[:, :0], m[:, :0]),
        "spmm_mask_dtype": lambda: tsp.block_spmm(tm.long(), tiles, x),
        "spmm_x_rows": lambda: tsp.block_spmm(tm, tiles, torch.zeros((257, 4))),
        "spmm_tiles_dim": lambda: tsp.block_spmm(tm, tiles[0], x),
        "spmm_strided": lambda: tsp.block_spmm(tm, tiles, torch.zeros((4, 256)).t()),
        # tiles are fixed at 128 x 128 until the port has an autotuner
        "spmm_tile_size": lambda: tsp.block_spmm(tm, torch.zeros((2, 2, 16, 16)),
                                                 torch.zeros((32, 4))),
    }
    with pytest.raises((TypeError, ValueError)):
        calls[bad]()


GNN_MODULES = [
    "kernels/csr_spmm.py", "kernels/segment_reduce.py", "kernels/ops.py", "kernels/ref.py",
    "configs/registry.py", "configs/graphsage_reddit.py", "configs/gcn_cora.py",
    "models/layers.py", "models/gnn/common.py", "models/gnn/graphsage.py",
    "models/gnn/gcn.py", "data/pipeline.py",
]


@pytest.mark.parametrize("module", GNN_MODULES)
def test_gnn_modules_import_neither_jax_nor_repro(module):
    tree = ast.parse((SRC / module).read_text())
    names = [n.module or "" for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
             and n.level == 0]
    names += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    roots = {name.split(".")[0] for name in names}
    assert not roots & {"jax", "jaxlib", "repro"}, roots


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run: python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["mean", "sum", "max"])
@pytest.mark.parametrize("B,K,D", [(1, 15, 602), (13, 10, 6), (1000, 10, 602), (64, 15, 128)])
def test_cuda_fanout_matches_plain(cuda, op, B, K, D):
    feats, mask = fanout_inputs(B, K, D, "fractional", seed=B + K + D)
    mask[::5] = 0.0
    f, m = _t(feats).to(cuda), _t(mask).to(cuda)
    before = sr.LAUNCHES["fanout_aggregate"]
    got = sr.fanout_aggregate(f, m, op)
    torch.cuda.synchronize()
    assert sr.LAUNCHES["fanout_aggregate"] == before + 1
    want = sr.fanout_aggregate_plain(f, m, op)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("n,E,D", [(256, 2000, 1), (300, 5000, 64), (2708, 10556, 1433)])
def test_cuda_block_spmm_matches_plain(cuda, n, E, D):
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(n + D)
    mask, tiles, _ = tsp.tiles_from_edges(n, rng.integers(0, n, E), rng.integers(0, n, E))
    mask[0, 0] = 0  # a nonzero tile masked off
    x = _t(rng.standard_normal((n, D)).astype(np.float32)).to(cuda)
    m, a = _t(mask).to(cuda), _t(tiles).to(cuda)
    before = tsp.LAUNCHES["block_spmm"]
    got = tsp.block_spmm(m, a, x)
    torch.cuda.synchronize()
    assert tsp.LAUNCHES["block_spmm"] == before + 1
    torch.testing.assert_close(got, tsp.block_spmm_plain(m, a, x), rtol=1e-5, atol=1e-4)


def test_block_spmm_plain_nonfinite_x_is_the_dense_product():
    """The plain version is the dense product: an inf in x gives NaN in
    every row whose tile holds that column, where A's entry is 0 (0 * inf);
    the kernel leaves zero entries out instead (the cuda test below)."""
    n = 256
    mask, tiles, _ = tsp.tiles_from_edges(n, np.array([0, 5]), np.array([3, 3]))
    x = torch.ones((n, 2))
    x[5, 0] = float("inf")
    got = tsp.block_spmm(_t(mask), _t(tiles), x)
    assert torch.isinf(got[3, 0]) and bool(torch.isnan(got[:128, 0][torch.arange(128) != 3]).all())
    assert bool(torch.isfinite(got[:, 1]).all()) and float(got[3, 1]) == 2.0


def cora_like(D, seed):
    """Cora's size: 2,708 vertices, 10,556 random directed edges with
    positive weights, x of width D."""
    rng = np.random.default_rng(seed)
    n, E = 2708, 10556
    src, dst = rng.integers(0, n, E), rng.integers(0, n, E)
    mask, tiles, _ = tsp.tiles_from_edges(n, src, dst, rng.random(E).astype(np.float32))
    return mask, tiles, rng.standard_normal((n, D)).astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [16, 1433])
def test_cuda_block_spmm_cora_same_bits_twice(cuda, D):
    """gcn-cora's two widths against the plain version, and two calls
    giving the same bits (a fixed order of summation, no atomics)."""
    mask, tiles, x = cora_like(D, seed=D)
    m, a, xd = _t(mask).to(cuda), _t(tiles).to(cuda), _t(x).to(cuda)
    first = tsp.block_spmm(m, a, xd)
    second = tsp.block_spmm(m, a, xd)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    torch.testing.assert_close(first, tsp.block_spmm_plain(m, a, xd), rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_cuda_block_spmm_leaves_zero_entries_out(cuda):
    """Non-finite x: the kernel sums the nonzero entries only, so an inf
    reaches just the rows whose entry for it is nonzero (the plain dense
    product gives NaN in the rest of the tile's rows)."""
    mask, tiles, _ = tsp.tiles_from_edges(256, np.array([0, 5]), np.array([3, 3]))
    x = torch.ones((256, 2), device=cuda)
    x[5, 0] = float("inf")
    got = tsp.block_spmm(_t(mask).to(cuda), _t(tiles).to(cuda), x).cpu()
    assert torch.isinf(got[3, 0]) and float(got[3, 1]) == 2.0
    others = torch.arange(256) != 3
    assert not bool(got[others].any()) and bool(torch.isfinite(got[others]).all())


@pytest.mark.cuda
def test_cuda_block_spmm_workspace_size_agrees_with_the_kernel(cuda):
    import ctypes

    from repro_torch.kernels import _build

    fn = _build.c_function("block_spmm", "repro_block_spmm_workspace_bytes",
                           [ctypes.c_int, ctypes.c_int], ctypes.c_longlong)
    for nr, nc in [(1, 1), (22, 22), (3, 7)]:
        assert fn(nr, nc) == tsp.workspace_bytes(nr, nc)
