"""Public wrappers the engine calls (never the kernel modules directly).

Counterpart of ``repro/kernels/ops.py:57-142`` (delta decode),
``:177-235`` and ``:299-378`` (segment sums), ``:381-387`` (fanout) and
``:394-400`` (flash decode), ``:408-444`` (block SpMM), with the sweep
factories ``:150`` (``_sweep_segment_sum``), ``:271``
(``_sweep_segment_sum_chunked``) and ``:414`` (``_sweep_spmm``).  The reference pads the
edge axis to whole edge blocks with an out-of-range dst (chunked: whole
chunk rows with an out-of-range anchor) and adds one
extra destination block to swallow the padding.  The Hopper kernels take
ragged shapes as they are and never visit a row at or past ``n_out``, so
the same contract — any ``dst >= n_out`` is dropped — holds with no
padding.  The reference also gathers an adaptive stream's compacted hi
plane into an aligned (R, CHUNK) transient (``_gather_hi``); the Hopper
kernels read the compacted plane in place (the decode finds each wide
chunk's row itself, the segment sums through an O(R) row index).
The decode wrappers need no padding either: the padded decode kernel
takes any row count and length, the chunked ones any row count.  Nor do
the GNN wrappers: the reference pads the fanout batch to a multiple of 8
and x to whole SpMM tiles, where the Hopper kernels take any B and read
rows of x past its end as zero.  Nor does the flash decode: the
reference pads S to whole 512-key blocks, where the Hopper kernel masks
by length and takes any S.

The segment sums and the SpMM take their launch tile from the autotuner
(``kernels/autotune.py``) unless the caller names one (``tile=``,
``row_tile=``/``col_tile=``), as the reference's block shapes do: a
consult per call, a sweep the first time a (kernel, device type, shape
bucket) is seen on the card.  The sweep factories build synthetic inputs
of the real shape from a seeded generator on the call's device, pass
explicit tiles (so a candidate's call skips the consult), and are
dropped, with their inputs, when the consult returns.  On the CPU the
consult returns the defaults and the plain versions run.

No hand kernel has a backward (nor has the reference's: it defines no
``custom_vjp``), so a kernel's output carries no ``grad_fn``.  Every
wrapper here that reaches a kernel raises ``RuntimeError`` when grad
mode is on and a float input requires grad, on every device, and names
the plain version to differentiate through; otherwise the CPU, where the
plain version runs and carries gradients, and the card, where the
kernel drops them, would train differently without an error.
"""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve
from ..core import compressed as cz
from ..core.chunks import PackedDeltas
from . import autotune, csr_spmm, delta_decode, flash_decode, segment_reduce


def _no_autograd(name: str, plain: str, *inputs) -> None:
    """Raise if autograd would need a backward through the hand kernel."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad and t.is_floating_point() for t in inputs):
        raise RuntimeError(
            f"kernels.ops.{name}: an input requires grad, and the hand kernel has no "
            f"backward (as in the reference, which defines no custom_vjp); call it under "
            f"torch.no_grad() or on detached inputs, or differentiate through the plain "
            f"path {plain}")


# ---------------------------------------------------------------------------
# delta decode (C-tree chunk decompression)
# ---------------------------------------------------------------------------


def decode_chunks(anchors: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Decode padded chunk deltas to absolute values: int32 (R, L) with
    ``out[i, j] = anchors[i] + sum(deltas[i, 1:j+1])``.  Column 0 is the
    anchor position: whatever a caller left there is dropped (normalized
    to 0), as the reference does."""
    d = deltas.to(torch.int32).clone()
    if d.shape[1]:
        d[:, 0] = 0  # enforce the anchor-column invariant
    return delta_decode.delta_decode_padded(anchors.to(torch.int32).contiguous(), d)


def decode_chunked_stream(
    anchors: torch.Tensor,
    deltas: torch.Tensor,
    ovf_pos: torch.Tensor,
    ovf_add: torch.Tensor,
    hi: torch.Tensor | None = None,
    wide: torch.Tensor | None = None,
) -> torch.Tensor:
    """Decode escape-lane chunk rows (a ``core/compressed.ChunkedStream``'s
    arrays) to int32 (R, L).  Pass ``hi``/``wide`` for adaptive streams;
    the compacted hi plane is read in place, with no gathered (R, L)
    plane."""
    a, d = anchors.to(torch.int32).contiguous(), deltas.contiguous()
    p, v = ovf_pos.to(torch.int32).contiguous(), ovf_add.to(torch.int32).contiguous()
    if hi is None:
        return delta_decode.delta_decode_chunked(a, d, p, v)
    return delta_decode.delta_decode_chunked_adaptive(a, d, hi.contiguous(), wide.contiguous(),
                                                      p, v)


def pool_rows(packed: PackedDeltas, device=None):
    """A host C-tree's ``chunks.PackedDeltas`` pool as padded rows on
    ``device`` (default the card): ``(anchors int32 (n_chunks,), rows
    int32 (n_chunks, L), slot int64 (n,))`` with L the longest chunk,
    escapes substituted, and pool element e at ``rows.view(-1)[slot[e]]``.
    The pool travels as it is stored; the rows are built there by one
    scatter."""
    if not isinstance(packed, PackedDeltas):
        raise TypeError(f"expected a chunks.PackedDeltas, got {type(packed).__name__}")
    dev = resolve(device)
    offs_np = np.asarray(packed.chunk_off, dtype=np.int64)
    n_chunks = max(offs_np.size - 1, 0)
    raw = np.asarray(packed.deltas)
    wide = raw.dtype == np.uint16
    # uint16 travels as its int16 bit pattern (torch's uint16 has few ops)
    d = torch.from_numpy(raw.view(np.int16) if wide else raw).to(dev).to(torch.int32)
    if wide:
        d &= 0xFFFF
    esc = np.iinfo(raw.dtype).max
    over = torch.from_numpy(np.asarray(packed.overflow, dtype=np.int64)).to(dev)
    d.masked_scatter_(d == esc, over.to(torch.int32))  # escapes, in pool order
    offs = torch.from_numpy(offs_np).to(dev)
    lens = torch.diff(offs)
    L = max(int(lens.max()), 1) if n_chunks else 0
    chunk_of = torch.repeat_interleave(torch.arange(n_chunks, device=dev), lens)
    slot = chunk_of * L + (torch.arange(d.shape[0], device=dev) - offs[chunk_of])
    rows = torch.zeros((n_chunks, L), dtype=torch.int32, device=dev)
    rows.view(-1)[slot] = d
    anchors = torch.from_numpy(np.asarray(packed.anchors, dtype=np.int64)).to(dev)
    return anchors.to(torch.int32), rows, slot


def decode_pool(packed: PackedDeltas, device=None) -> np.ndarray:
    """Decode a host C-tree's ``chunks.PackedDeltas`` pool through the
    padded decode on ``device`` (default the card): int64 (n,) equal to
    ``chunks.unpack_deltas(packed)`` for ids that fit int32."""
    anchors, rows, slot = pool_rows(packed, device)
    if rows.shape[0] == 0:
        return np.empty(0, dtype=np.int64)
    return decode_chunks(anchors, rows).view(-1)[slot].to(torch.int64).cpu().numpy()


# ---------------------------------------------------------------------------
# segment reduce
# ---------------------------------------------------------------------------


def _sweep_segment_sum(E: int, n_out: int, D: int, weighted: bool, device: torch.device):
    """sweep_fn factory: a synthetic sorted segment sum of the real shape
    (E keys drawn uniformly below n_out and sorted, (E, D) messages),
    built at the first candidate and kept for the others."""
    inputs = []

    def make(params):
        if not inputs:
            gen = torch.Generator(device=device).manual_seed(0)
            E1 = max(E, 1)
            dst = torch.randint(0, max(n_out, 1), (E1,), generator=gen, device=device,
                                dtype=torch.int32)
            inputs.extend([torch.sort(dst).values,
                           torch.rand((E1,), generator=gen, device=device),
                           torch.rand((E1, D), generator=gen, device=device)])
        dst, w, msg = inputs
        if weighted:
            return lambda: segment_sum_weighted(dst, w, msg, n_out, **params)
        return lambda: segment_sum(dst, msg, n_out, **params)

    return make


def _tile(kernel: str, shape: dict, make, device: torch.device) -> int:
    return autotune.get_params(kernel, shape, sweep_fn=make, backend=device.type)["tile"]


def segment_sum(dst: torch.Tensor, msg: torch.Tensor, n_out: int,
                tile: int | None = None) -> torch.Tensor:
    """Sorted segment sum: float32 (n_out, D) from dst (E,) and msg (E, D).
    ``tile``: slots a block of the kernel's pass; default the autotuner's
    winner for the shape."""
    _no_autograd("segment_sum", "kernels.segment_reduce.segment_sum_sorted_plain", msg)
    E, D = msg.shape
    if tile is None:
        tile = _tile("segment_sum", {"E": E, "n": n_out, "D": D},
                     _sweep_segment_sum(E, n_out, D, False, msg.device), msg.device)
    return segment_reduce.segment_sum_sorted(
        dst.to(torch.int32).contiguous(), msg.to(torch.float32).contiguous(), int(n_out),
        tile=tile,
    )


def segment_sum_weighted(
    dst: torch.Tensor, w: torch.Tensor, msg: torch.Tensor, n_out: int, tile: int | None = None
) -> torch.Tensor:
    """Weighted sorted segment sum (out[d] = sum w[e] * msg[e]); same
    dropping contract and tile as ``segment_sum``."""
    _no_autograd("segment_sum_weighted",
                 "kernels.segment_reduce.segment_sum_weighted_sorted_plain", w, msg)
    E, D = msg.shape
    if tile is None:
        tile = _tile("segment_sum_weighted", {"E": E, "n": n_out, "D": D},
                     _sweep_segment_sum(E, n_out, D, True, msg.device), msg.device)
    return segment_reduce.segment_sum_weighted_sorted(
        dst.to(torch.int32).contiguous(),
        w.to(torch.float32).contiguous(),
        msg.to(torch.float32).contiguous(),
        int(n_out),
        tile=tile,
    )


def _sweep_segment_sum_chunked(R: int, n_out: int, D: int, weighted: bool, width: int,
                               adaptive: bool, device: torch.device):
    """sweep_fn factory for the chunked sums: R * CHUNK keys drawn
    uniformly below n_out, sorted and encoded in the call's layout
    (fixed ``width``, or adaptive), with (R * CHUNK, D) messages."""
    inputs = []

    def make(params):
        if not inputs:
            gen = torch.Generator(device=device).manual_seed(0)
            E = max(R, 1) * cz.CHUNK
            lane = torch.sort(torch.randint(0, max(n_out, 1), (E,), generator=gen, device=device,
                                            dtype=torch.int32)).values
            s = (cz.encode_stream_adaptive(lane, hi_cap=max(R, 1)) if adaptive
                 else cz.encode_stream(lane, width=width))
            inputs.extend([s, torch.rand((E,), generator=gen, device=device),
                           torch.rand((E, D), generator=gen, device=device)])
        s, w, msg = inputs
        args = (s.anchors, s.deltas, s.ovf_pos, s.ovf_add)
        if weighted:
            return lambda: segment_sum_weighted_chunked(*args, w, msg, n_out, hi=s.hi,
                                                        wide=s.wide, **params)
        return lambda: segment_sum_chunked(*args, msg, n_out, hi=s.hi, wide=s.wide, **params)

    return make


def _chunked_tile(kernel: str, deltas: torch.Tensor, msg: torch.Tensor, n_out: int,
                  weighted: bool, adaptive: bool) -> int:
    R, D = deltas.shape[0], msg.shape[1]
    make = _sweep_segment_sum_chunked(R, n_out, D, weighted, deltas.element_size(), adaptive,
                                      msg.device)
    return _tile(kernel, {"R": R, "n": n_out, "D": D}, make, msg.device)


def segment_sum_chunked(
    anchors: torch.Tensor,
    deltas: torch.Tensor,
    ovf_pos: torch.Tensor,
    ovf_add: torch.Tensor,
    msg: torch.Tensor,
    n_out: int,
    hi: torch.Tensor | None = None,
    wide: torch.Tensor | None = None,
    tile: int | None = None,
) -> torch.Tensor:
    """``segment_sum`` with a chunk-compressed dst lane (a
    ``core/compressed.ChunkedStream``'s arrays), decoded inside the kernel.
    msg row ``r * CHUNK + c`` pairs with chunk ``r`` column ``c``.  Pass
    ``hi``/``wide`` for adaptive streams (which consult under this
    kernel's key, as the reference's do)."""
    _no_autograd("segment_sum_chunked", "kernels.segment_reduce.segment_sum_sorted_chunked_plain",
                 msg)
    if tile is None:
        tile = _chunked_tile("segment_sum_chunked", deltas, msg, n_out, False, hi is not None)
    args = _chunk_args(anchors, deltas, ovf_pos, ovf_add)
    m = msg.to(torch.float32).contiguous()
    if hi is None:
        return segment_reduce.segment_sum_sorted_chunked(*args, m, int(n_out), tile=tile)
    a, d, p, v = args
    return segment_reduce.segment_sum_sorted_chunked_adaptive(
        a, d, hi.contiguous(), wide.contiguous(), p, v, m, int(n_out), tile=tile)


def segment_sum_weighted_chunked(
    anchors: torch.Tensor,
    deltas: torch.Tensor,
    ovf_pos: torch.Tensor,
    ovf_add: torch.Tensor,
    w: torch.Tensor,
    msg: torch.Tensor,
    n_out: int,
    hi: torch.Tensor | None = None,
    wide: torch.Tensor | None = None,
    tile: int | None = None,
) -> torch.Tensor:
    """Weighted ``segment_sum_chunked`` (weight pads are 0)."""
    _no_autograd("segment_sum_weighted_chunked",
                 "kernels.segment_reduce.segment_sum_weighted_chunked_plain", w, msg)
    if tile is None:
        tile = _chunked_tile("segment_sum_weighted_chunked", deltas, msg, n_out, True,
                             hi is not None)
    args = _chunk_args(anchors, deltas, ovf_pos, ovf_add)
    wf = w.to(torch.float32).contiguous()
    m = msg.to(torch.float32).contiguous()
    if hi is None:
        return segment_reduce.segment_sum_weighted_chunked(*args, wf, m, int(n_out), tile=tile)
    a, d, p, v = args
    return segment_reduce.segment_sum_weighted_chunked_adaptive(
        a, d, hi.contiguous(), wide.contiguous(), p, v, wf, m, int(n_out), tile=tile)


def _chunk_args(anchors, deltas, ovf_pos, ovf_add):
    return (anchors.to(torch.int32).contiguous(), deltas.contiguous(),
            ovf_pos.to(torch.int32).contiguous(), ovf_add.to(torch.int32).contiguous())


# ---------------------------------------------------------------------------
# fixed-fanout aggregation (GraphSAGE minibatch)
# ---------------------------------------------------------------------------


def fanout_aggregate(feats: torch.Tensor, mask: torch.Tensor, op: str = "mean") -> torch.Tensor:
    """Masked mean / sum / max over the K sampled neighbours: (B, K, D)
    features and a (B, K) mask of any type (cast to float32) -> (B, D)."""
    _no_autograd("fanout_aggregate", "kernels.segment_reduce.fanout_aggregate_plain",
                 feats, mask)
    return segment_reduce.fanout_aggregate(
        feats.to(torch.float32).contiguous(), mask.to(torch.float32).contiguous(), op)


# ---------------------------------------------------------------------------
# attention decode
# ---------------------------------------------------------------------------


def flash_decode_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Single-token GQA attention: q (BH, Q, d), k and v (BH, S, d) of any
    S, ``lengths`` (BH,) valid keys per row -> (BH, Q, d) in q's dtype."""
    _no_autograd("flash_decode_attn", "kernels.flash_decode.flash_decode_plain", q, k, v)
    return flash_decode.flash_decode(q, k, v, lengths)


# ---------------------------------------------------------------------------
# block SpMM
# ---------------------------------------------------------------------------


def spmm(tile_mask: torch.Tensor, a_tiles: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Block-dense ``A @ x`` over unmasked tiles: float32 (nr * R, D)."""
    _no_autograd("spmm", "kernels.csr_spmm.block_spmm_plain", a_tiles, x)
    return csr_spmm.block_spmm(tile_mask.to(torch.int32).contiguous(),
                               a_tiles.to(torch.float32).contiguous(),
                               x.to(torch.float32).contiguous())


def _sweep_spmm(n: int, m: int, D: int, device: torch.device):
    """sweep_fn factory for the SpMM tiles: m random edges over n
    vertices (host arrays, as the entry point takes them) and (n, D)
    features; each candidate's tiles are built before its timing, so
    the sweep times the kernel's launches, not the host build."""
    inputs = []

    def make(params):
        if not inputs:
            gen = torch.Generator().manual_seed(0)  # the edges are host arrays
            src = torch.randint(0, max(n, 1), (max(m, 1),), generator=gen).numpy()
            dst = torch.randint(0, max(n, 1), (max(m, 1),), generator=gen).numpy()
            x = torch.rand((n, D), generator=torch.Generator(device=device).manual_seed(0),
                           device=device)
            inputs.extend([src, dst, x])
        src, dst, x = inputs
        mask, tiles, _ = csr_spmm.tiles_from_edges(n, src, dst, None, **params)
        mask, tiles = torch.from_numpy(mask).to(device), torch.from_numpy(tiles).to(device)
        return lambda: spmm(mask, tiles, x)

    return make


def spmm_from_edges(n: int, src, dst, x: torch.Tensor, vals=None,
                    row_tile: int | None = None, col_tile: int | None = None) -> torch.Tensor:
    """``A @ x`` with ``A[dst, src] += vals`` (unit values by default) for
    an edge list given as host arrays: tiles built on the host
    (``csr_spmm.tiles_from_edges``), moved to x's device, then ``spmm``;
    returns float32 (n, D).  The tiles are the autotuner's winner for
    ``{"n", "m"}`` (its sweep runs at x's width) unless both are named."""
    _no_autograd("spmm_from_edges", "kernels.csr_spmm.block_spmm_plain over the tiles of "
                 "kernels.csr_spmm.tiles_from_edges", x, vals)
    if row_tile is None or col_tile is None:
        m = int(np.asarray(src).shape[0])
        tuned = autotune.get_params("spmm", {"n": n, "m": m},
                                    sweep_fn=_sweep_spmm(n, m, x.shape[1], x.device),
                                    backend=x.device.type)
        row_tile = row_tile or tuned["row_tile"]
        col_tile = col_tile or tuned["col_tile"]
    mask, tiles, _ = csr_spmm.tiles_from_edges(n, src, dst, vals, row_tile=row_tile,
                                               col_tile=col_tile)
    out = spmm(torch.from_numpy(mask).to(x.device), torch.from_numpy(tiles).to(x.device), x)
    return out[:n]
