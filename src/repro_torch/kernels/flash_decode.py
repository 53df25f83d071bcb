"""Flash-decode attention (one new token against a KV cache, GQA): the
wrapper around the Hopper kernel, its launch counter and its plain
PyTorch version.

Counterpart of ``repro/kernels/flash_decode.py`` (``flash_decode`` at
``:73``).  The kernel lives in ``csrc/flash_decode.cu``; see its comments
for the design (S split across blocks, then a combine pass) and the
bound.

Contract, for BH = B * n_kv rows of Q = n_heads / n_kv query rows each:
``q`` (BH, Q, d), ``k`` and ``v`` (BH, S, d), ``lengths`` (BH,) integer;
returns (BH, Q, d) in q's dtype with
``out[r] = softmax(q[r] k[r]^T / sqrt(d), positions >= lengths[r] masked) v[r]``
computed as the reference's online softmax: float32 scores and sums (no
TF32), ``acc / max(l, 1e-30)``, so a row of length 0 gives 0.  q, k and
v are float32 or bf16; k and v share a dtype, and q may differ from it
(the reference's ``generate`` pairs an f32 model with its bf16 cache; the
kernel, like the TPU one, reads every operand as float32).  Any S: no
padding to the reference's 512-key blocks.

``flash_decode_cache`` is the strided entry ``attention_decode`` uses:
q (B, n_kv, Q, d), one layer's cache slices (B, S_max, n_kv, d) read in
place through their strides, lengths (B,) per sequence.

``return_lse=True`` (either entry, and the plain versions) also returns
each query row's log-sum-exp, float32 (BH, Q) ((B, n_kv, Q) from the
strided entry): ``log sum_t exp(q[r] k[r, t] / sqrt(d))`` over the valid
positions, -inf for a row of length 0.  Partial results over blocks of
positions combine with it (``dist.spmd.flash_decode_on_local_shards`` on
a sequence-sharded cache).  The kernel writes it from the block that
writes the row's output; without it the output's bits do not change.

Routes: a cache whose row bytes (d * elem) and used strides are multiples
of 16 bytes, with both bases 16-byte aligned and S >= 1, takes the TMA
route (``tma_route``); any other (d = 12 in bf16 has 24-byte rows) the
cp.async route.  Both are the hand kernel; ``LAUNCHES`` counts calls in
all and per route.

Dispatch: a tensor on the CPU gets the plain version; a CUDA tensor gets
the kernel or an exception, never the plain version.  One call is one CUDA
launch: the split pass merges its own partials (the last block of each
row), through a float32 workspace of ``workspace_floats`` and a per-row
counter that each call leaves at zero.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

MAX_D = 256
MAX_Q = 16
_DTYPES = (torch.float32, torch.bfloat16)

# Calls that launched the kernel in this process, in all and per route
# (bumped only where it launches).
LAUNCHES = {"flash_decode": 0, "flash_decode_tma": 0, "flash_decode_cpasync": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
           batch: int) -> None:
    """q (rows, Q, d) against k, v (batch, S, ..., d); raises on what the
    kernel does not take."""
    if len({t.device for t in (q, k, v, lengths)}) != 1:
        raise ValueError("flash_decode: all operands must be on one device")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES:
        raise TypeError(f"flash_decode takes float32 or bf16, got q {q.dtype}, k {k.dtype}")
    if k.dtype != v.dtype:
        raise TypeError(f"flash_decode: k and v must share a dtype, got {k.dtype} and {v.dtype}")
    if lengths.dtype.is_floating_point or lengths.dtype == torch.bool:
        raise TypeError(f"flash_decode: lengths must be integers, got {lengths.dtype}")
    if k.shape != v.shape or k.shape[0] != batch or tuple(lengths.shape) != (batch,):
        raise ValueError(f"flash_decode: k {tuple(k.shape)}, v {tuple(v.shape)} and lengths "
                         f"{tuple(lengths.shape)} do not match {batch} rows")
    Q, d = q.shape[-2], q.shape[-1]
    if k.shape[-1] != d:
        raise ValueError(f"flash_decode: head dim {k.shape[-1]} of k against {d} of q")
    if not (1 <= Q <= MAX_Q and 1 <= d <= MAX_D):
        raise ValueError(f"flash_decode takes 1 <= Q <= {MAX_Q} and 1 <= d <= {MAX_D}, "
                         f"got Q = {Q}, d = {d}")
    if k.shape[1] >= 2**30 or q.numel() >= 2**31:
        raise ValueError("flash_decode shapes out of int32 range")


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       lengths: torch.Tensor, return_lse: bool = False):
    """Plain PyTorch version: the masked softmax in float32 with einsums,
    guarded as the kernel is (masked positions weigh 0, a row with no
    valid position gives 0 and log-sum-exp -inf)."""
    qf, kf, vf = q.float(), k.float(), v.float()
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqd,bsd->bqs", qf, kf) * scale
    pos = torch.arange(k.shape[1], device=k.device)
    valid = pos[None, None, :] < lengths.to(k.device).long()[:, None, None]
    s = torch.where(valid, s, -torch.inf)
    m = s.amax(-1, keepdim=True) if s.shape[-1] else s.new_zeros(s.shape[:-1] + (1,))
    m = torch.where(torch.isfinite(m), m, 0.0)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    o = torch.einsum("bqs,bsd->bqd", p, vf) / torch.clamp(l, min=1e-30)
    if not return_lse:
        return o.to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(l), -torch.inf)[..., 0]
    return o.to(q.dtype), lse


def flash_decode_cache_plain(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                             lengths: torch.Tensor, return_lse: bool = False):
    """Plain version of the strided entry: the reference's transposed
    (B * n_kv, S_max, d) copies of the cache, each sequence's length
    repeated over its kv heads, then ``flash_decode_plain``."""
    B, n_kv, Q, d = q.shape
    S = k_cache.shape[1]
    kf = k_cache.permute(0, 2, 1, 3).reshape(B * n_kv, S, d)
    vf = v_cache.permute(0, 2, 1, 3).reshape(B * n_kv, S, d)
    o = flash_decode_plain(q.reshape(B * n_kv, Q, d), kf, vf, lengths.repeat_interleave(n_kv),
                           return_lse)
    if not return_lse:
        return o.reshape(B, n_kv, Q, d)
    return o[0].reshape(B, n_kv, Q, d), o[1].reshape(B, n_kv, Q)


def tma_route(k: torch.Tensor, v: torch.Tensor, sizes, kstrides, vstrides) -> bool:
    """Whether the cache k, v takes the TMA route: its rows (d * elem
    bytes) and the strides of every dimension longer than 1 (``sizes``
    and strides in elements, for (batch, position, head)) are multiples of
    16 bytes below 2^40, both bases are 16-byte aligned, and there is at
    least one position.  The kernel's TMA box is the whole row; every
    other cache takes the cp.async route."""
    elem = k.element_size()
    if (k.shape[-1] * elem) % 16 or k.data_ptr() % 16 or v.data_ptr() % 16 or sizes[1] < 1:
        return False
    for n, ks, vs in zip(sizes, kstrides, vstrides):
        if n > 1 and ((ks * elem) % 16 or (vs * elem) % 16 or max(ks, vs) * elem >= 2**40):
            return False
    return True


def workspace_floats(BH: int, n_split: int, Q: int, d: int) -> int:
    """float32 workspace of one call: each split's partial (m, l, acc),
    none with a single split."""
    return 0 if n_split == 1 else BH * n_split * Q * (d + 2)


@functools.lru_cache(maxsize=None)
def _plan(BH: int, S: int, Q: int, d: int, kv_bf16: int, tma: int, device: torch.device):
    """(n_split, chunk, keys per tile, ring stages, shared bytes) from
    ``repro_flash_decode_plan`` for these shapes and route; sets the
    kernel's shared-memory limit on the device."""
    out = torch.zeros(5, dtype=torch.int32)
    _build.launch("flash_decode", "repro_flash_decode_plan",
                  [ctypes.c_int(BH), ctypes.c_int(S), ctypes.c_int(Q), ctypes.c_int(d),
                   ctypes.c_int(kv_bf16), ctypes.c_int(tma), out], device)
    return tuple(int(x) for x in out)


_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# repro_flash_decode(q, q_bf16, k, v, kv_bf16, lengths, out, lse, work, counters,
# B, n_kv, S, Q, d, 6 strides, n_split, chunk, tma, stream)
_ARGTYPES = [_P, _I, _P, _P, _I, _P, _P, _P, _P, _P, *[_I] * 5, *[_L] * 6, _I, _I, _I, _P]


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
            B: int, n_kv: int, kstrides, vstrides, return_lse: bool = False):
    """One launch of the kernel; k, v element (b, t, h, j) at
    b * strides[0] + t * strides[1] + h * strides[2] + j; with
    ``return_lse`` also the float32 (BH, Q) log-sum-exp.  The per-row
    counters and the partials are buffers kept per stream
    (``_build.scratch``): a decode step's 32 calls allocate only their
    outputs."""
    if k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("flash_decode: the head dim of k and v must be contiguous")
    kv_bf16 = int(k.dtype == torch.bfloat16)
    dev = q.device
    Q, d, S = q.shape[-2], q.shape[-1], k.shape[1]
    BH = B * n_kv
    tma = int(tma_route(k, v, (B, S, n_kv), kstrides, vstrides))  # implies even bf16 strides
    if (not tma and kv_bf16
            and (k.shape[-1] % 2 or any(s % 2 for s in (*kstrides, *vstrides)))):
        raise ValueError("flash_decode: bf16 k and v need an even head dim and even strides")
    q = q.contiguous()
    lens = lengths
    if lens.dtype != torch.int32 or not lens.is_contiguous():
        lens = lens.to(torch.int32).contiguous()
    n_split, chunk = _plan(BH, S, Q, d, kv_bf16, tma, dev)[:2]
    out = torch.empty_like(q)
    lse = torch.empty((BH, Q), dtype=torch.float32, device=dev) if return_lse else None
    fn = _build.c_function("flash_decode", "repro_flash_decode", _ARGTYPES)

    def launches() -> None:
        counters = _build.scratch("flash_counters", dev, 4 * BH, zeroed=True)
        work = _build.scratch("flash_partials", dev, 4 * workspace_floats(BH, n_split, Q, d))
        _build.call(fn, "repro_flash_decode",
                    [q.data_ptr(), int(q.dtype == torch.bfloat16), k.data_ptr(), v.data_ptr(),
                     kv_bf16, lens.data_ptr(), out.data_ptr(),
                     None if lse is None else lse.data_ptr(), work.data_ptr(),
                     counters.data_ptr(), B, n_kv, S, Q, d, *kstrides, *vstrides, n_split,
                     chunk, tma], dev.index)

    _build.launch_with_scratch(launches, LAUNCHES, "flash_decode",
                               "flash_decode_tma" if tma else "flash_decode_cpasync")
    return out if lse is None else (out, lse)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, return_lse: bool = False):
    """Single-token attention of q (BH, Q, d) over k, v (BH, S, d) with
    ``lengths`` (BH,) valid keys per row: (BH, Q, d) in q's dtype (and
    the (BH, Q) log-sum-exp with ``return_lse``)."""
    if q.dim() != 3 or k.dim() != 3:
        raise ValueError(f"flash_decode takes q (BH, Q, d) and k, v (BH, S, d), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}")
    _check(q, k, v, lengths, q.shape[0])
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, lengths, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    return _launch(q, k, v, lengths, q.shape[0], 1, (k.stride(0), k.stride(1), 0),
                   (v.stride(0), v.stride(1), 0), return_lse)


def flash_decode_cache(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                       lengths: torch.Tensor, return_lse: bool = False):
    """The strided entry: q (B, n_kv, Q, d) over one layer's cache slices
    k_cache, v_cache (B, S_max, n_kv, d), as they lie, with ``lengths``
    (B,) valid positions per sequence: (B, n_kv, Q, d) in q's dtype (and
    the (B, n_kv, Q) log-sum-exp with ``return_lse``)."""
    if q.dim() != 4 or k_cache.dim() != 4 or k_cache.shape[2] != q.shape[1]:
        raise ValueError(f"flash_decode_cache takes q (B, n_kv, Q, d) and caches "
                         f"(B, S_max, n_kv, d), got {tuple(q.shape)}, {tuple(k_cache.shape)}")
    B, n_kv, Q, d = q.shape
    _check(q, k_cache, v_cache, lengths, B)
    if q.device.type == "cpu":
        return flash_decode_cache_plain(q, k_cache, v_cache, lengths, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_cache: unsupported device {q.device}")
    res = _launch(q, k_cache, v_cache, lengths, B, n_kv,
                  (k_cache.stride(0), k_cache.stride(1), k_cache.stride(2)),
                  (v_cache.stride(0), v_cache.stride(1), v_cache.stride(2)), return_lse)
    return res if not return_lse else (res[0], res[1].reshape(B, n_kv, Q))
