"""Every hand-kernel wrapper of ``repro_torch.kernels.ops`` refuses
autograd, on every device.

No hand kernel has a backward (the reference defines no ``custom_vjp``),
so a wrapper raises ``RuntimeError`` when grad mode is on and a float
input requires grad; the message names the plain path to differentiate
through.  Under ``torch.no_grad()``, or with inputs that need no grad,
the wrappers return what they returned before: the same bits as the
plain version on the same inputs (here on the CPU, where the wrapper
runs that plain version).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import compressed as cz
from repro_torch.kernels import csr_spmm, flash_decode, ops, segment_reduce

GEN = torch.Generator().manual_seed(0)


def _rand(*shape):
    return torch.rand(shape, generator=GEN)


def seg_inputs():
    dst = torch.sort(torch.randint(0, 20, (300,), generator=GEN, dtype=torch.int32)).values
    return dst, _rand(300), _rand(300, 4)


def chunked_inputs():
    lane = torch.sort(torch.randint(0, 20, (2 * cz.CHUNK,), generator=GEN,
                                    dtype=torch.int32)).values
    s = cz.encode_stream(lane, width=1)
    return s, _rand(2 * cz.CHUNK), _rand(2 * cz.CHUNK, 3)


def spmm_inputs():
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, 40, 200), rng.integers(0, 40, 200)
    mask, tiles, _ = csr_spmm.tiles_from_edges(40, src, dst, None, row_tile=128, col_tile=128)
    return src, dst, torch.from_numpy(mask), torch.from_numpy(tiles), _rand(40, 5)


def case(name):
    """(call(grad_input), the float input that may require grad, plain(x))."""
    if name == "segment_sum":
        dst, _, msg = seg_inputs()
        return (lambda m: ops.segment_sum(dst, m, 20), msg,
                lambda m: segment_reduce.segment_sum_sorted_plain(dst, m, 20))
    if name == "segment_sum_weighted":
        dst, w, msg = seg_inputs()
        return (lambda ww: ops.segment_sum_weighted(dst, ww, msg, 20), w,
                lambda ww: segment_reduce.segment_sum_weighted_sorted_plain(dst, ww, msg, 20))
    if name == "segment_sum_chunked":
        s, _, msg = chunked_inputs()
        a = (s.anchors, s.deltas, s.ovf_pos, s.ovf_add)
        return (lambda m: ops.segment_sum_chunked(*a, m, 20), msg,
                lambda m: segment_reduce.segment_sum_sorted_chunked_plain(*a, m, 20))
    if name == "segment_sum_weighted_chunked":
        s, w, msg = chunked_inputs()
        a = (s.anchors, s.deltas, s.ovf_pos, s.ovf_add)
        return (lambda m: ops.segment_sum_weighted_chunked(*a, w, m, 20), msg,
                lambda m: segment_reduce.segment_sum_weighted_chunked_plain(*a, w, m, 20))
    if name == "fanout_aggregate":
        feats, mask = _rand(6, 5, 4), _rand(6, 5) < 0.6
        return (lambda f: ops.fanout_aggregate(f, mask, "mean"), feats,
                lambda f: segment_reduce.fanout_aggregate_plain(f, mask.float(), "mean"))
    if name == "flash_decode_attn":
        q, k, v = _rand(3, 1, 8), _rand(3, 50, 8), _rand(3, 50, 8)
        lengths = torch.tensor([50, 7, 1], dtype=torch.int32)
        return (lambda kk: ops.flash_decode_attn(q, kk, v, lengths), k,
                lambda kk: flash_decode.flash_decode_plain(q, kk, v, lengths))
    if name == "spmm":
        _, _, mask, tiles, x = spmm_inputs()
        return (lambda xx: ops.spmm(mask, tiles, xx), x,
                lambda xx: csr_spmm.block_spmm_plain(mask.to(torch.int32), tiles, xx))
    if name == "spmm_from_edges":
        src, dst, mask, tiles, x = spmm_inputs()
        return (lambda xx: ops.spmm_from_edges(40, src, dst, xx, row_tile=128, col_tile=128), x,
                lambda xx: csr_spmm.block_spmm_plain(mask.to(torch.int32), tiles, xx)[:40])
    raise KeyError(name)


WRAPPERS = ["segment_sum", "segment_sum_weighted", "segment_sum_chunked",
            "segment_sum_weighted_chunked", "fanout_aggregate", "flash_decode_attn", "spmm",
            "spmm_from_edges"]


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_raises_when_an_input_requires_grad(name):
    call, x, _ = case(name)
    with pytest.raises(RuntimeError, match=rf"ops\.{name}: .*no backward.*plain path kernels\."):
        call(x.clone().requires_grad_(True))


@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_unchanged_under_no_grad_and_without_grad(name):
    call, x, plain = case(name)
    want = plain(x)
    assert torch.equal(call(x), want)
    with torch.no_grad():
        got = call(x.clone().requires_grad_(True))
    assert torch.equal(got, want) and not got.requires_grad


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run: python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", WRAPPERS)
def test_cuda_wrapper_raises_before_a_launch(name, cuda):
    """On the card a float input that requires grad raises too, before
    any kernel is launched."""
    call, x, _ = case(name)
    x = x.to(cuda)
    mod = {"fanout_aggregate": segment_reduce, "flash_decode_attn": flash_decode,
           "spmm": csr_spmm, "spmm_from_edges": csr_spmm}.get(name, segment_reduce)
    before = sum(mod.LAUNCHES.values())
    with pytest.raises(RuntimeError, match="no backward"):
        call(x.clone().requires_grad_(True))
    assert sum(mod.LAUNCHES.values()) == before
