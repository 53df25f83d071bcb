"""Aspen graph on the device: CSR over a sorted pool of packed edge keys.

Counterpart of ``repro/core/flat_graph.py``.  The whole edge set is ONE
flat C-tree over packed 64-bit keys ``(src << 32) | dst``: CSR's edge
array *is* the sorted pool, and each vertex's adjacency list is a
contiguous key range.  A batch update is the flat C-tree rank-merge over
packed keys followed by an O(n) offsets rebuild (one searchsorted).  The
``CompressedPool`` keeps the same CSR with the dst lane chunk-compressed
(``core/compressed.py``, paper §3.2) and src implied by the offsets.

The reference's buffer donation has no counterpart: the old pool is
freed when the last version holding it is collected.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .._device import resolve
from . import compressed as cz
from . import flat_ctree as fct
from .hash import is_head_torch

SENT64 = fct.SENTINEL64


class FlatGraph(NamedTuple):
    """Immutable graph snapshot.  ``weights`` optionally carries one
    float32 per pool slot, parallel to ``keys``: every rank-merge or
    compaction permutes it alongside the keys, inserting a duplicate key
    overwrites its weight, deleting a key drops it."""

    offsets: torch.Tensor  # int32[n+1] CSR offsets (valid prefix of pool)
    keys: torch.Tensor  # int64[cap] sorted packed (src<<32|dst); pad SENT64
    m: torch.Tensor  # int32 0-dim: valid edge count
    weights: Optional[torch.Tensor] = None  # float32[cap] per-edge values (pad 0)

    @property
    def n(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def edge_capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def device(self) -> torch.device:
        return self.keys.device


def pack(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    return (src.to(torch.int64) << 32) | dst.to(torch.int64)


def unpack(keys: torch.Tensor):
    return (keys >> 32).to(torch.int32), (keys & 0xFFFFFFFF).to(torch.int32)


def _offsets_from_keys(keys: torch.Tensor, m: torch.Tensor, n: int) -> torch.Tensor:
    """offsets[v] = #edges with src < v; one vectorized searchsorted."""
    bounds = torch.arange(n + 1, dtype=torch.int64, device=keys.device) << 32
    offs = torch.searchsorted(keys, bounds).to(torch.int32)
    return torch.minimum(offs, m.to(torch.int32))


def from_edges(
    n: int,
    edges: np.ndarray,
    edge_capacity: int | None = None,
    weights: np.ndarray | None = None,
    device=None,
) -> FlatGraph:
    """Build from a (k, 2) directed edge array (dedups; a duplicated edge
    keeps the FIRST occurrence's weight).  The keys are sorted on the
    device, so a large edge set costs one host->device copy."""
    dev = resolve(device)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    packed = torch.from_numpy((edges[:, 0] << 32) | edges[:, 1]).to(dev)
    w = None
    if weights is None:
        keys = torch.sort(packed).values
    else:
        keys, order = torch.sort(packed, stable=True)
        w = torch.from_numpy(np.asarray(weights, dtype=np.float32).reshape(-1)).to(dev)[order]
    keep = fct._dedup_mask(keys, keys.shape[0])
    if edge_capacity is None:
        edge_capacity = fct.grown_capacity(int(keep.sum()))
    pool = fct._compact(keys, keep, edge_capacity, vals=w)
    return FlatGraph(_offsets_from_keys(pool.data, pool.n, n), pool.data, pool.n, pool.vals)


def from_state(offsets, keys, m, weights=None, device=None) -> FlatGraph:
    """The port's FlatGraph from the reference's leaves as numpy arrays
    (``np.asarray(g.offsets)``, ``np.asarray(g.keys)``, ``int(g.m)``,
    ``np.asarray(g.weights)``)."""
    dev = resolve(device)
    return FlatGraph(
        torch.from_numpy(np.array(offsets, dtype=np.int32)).to(dev),
        torch.from_numpy(np.array(keys, dtype=np.int64)).to(dev),
        torch.tensor(int(m), dtype=torch.int32, device=dev),
        None if weights is None else torch.from_numpy(np.array(weights, np.float32)).to(dev),
    )


def with_unit_weights(g: FlatGraph) -> FlatGraph:
    """Attach a unit value array to an unweighted graph (the upgrade an
    unweighted pool takes when its first weighted batch arrives)."""
    if g.weights is not None:
        return g
    return g._replace(weights=torch.ones(g.edge_capacity, dtype=torch.float32, device=g.device))


def to_edge_array(g: FlatGraph) -> np.ndarray:
    k = g.keys[: int(g.m)].cpu().numpy()
    return np.stack([k >> 32, k & 0xFFFFFFFF], axis=1)


def to_weight_array(g: FlatGraph) -> np.ndarray | None:
    """Per-edge weights aligned with ``to_edge_array`` (None when
    unweighted)."""
    return None if g.weights is None else g.weights[: int(g.m)].cpu().numpy()


# ---------------------------------------------------------------------------
# queries
# ---------------------------------------------------------------------------


def degrees(g: FlatGraph) -> torch.Tensor:
    return torch.diff(g.offsets)


def edge_endpoints(g: FlatGraph):
    """(src, dst) int32 per pool slot (padding slots give ids out of range)."""
    return unpack(g.keys)


def has_edge(g: FlatGraph, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    q = pack(src, dst)
    idx = torch.searchsorted(g.keys, q).clamp_max_(g.keys.shape[0] - 1)
    return g.keys[idx] == q


def chunk_structure(g: FlatGraph, b: int, seed: int) -> torch.Tensor:
    """Canonical chunk boundaries over the pool: head iff hash(dst) mod b
    == 0 OR first edge of a vertex (every adjacency list restarts its
    prefix, as the per-vertex C-trees of the tree level do)."""
    src, dst = unpack(g.keys)
    valid = torch.arange(g.edge_capacity, device=g.device) < g.m
    hm = is_head_torch(dst, b, seed) & valid
    first = torch.zeros(g.edge_capacity + 1, dtype=torch.bool, device=g.device)
    first[g.offsets[:-1].long()] = True  # an offset at the capacity hits the sink slot
    return hm | (first[:-1] & valid)


# ---------------------------------------------------------------------------
# batch updates: the streaming hot path
# ---------------------------------------------------------------------------


def insert_edges(
    g: FlatGraph, batch: fct.FlatCTree, out_cap: int, n_out: int | None = None
) -> FlatGraph:
    """InsertEdges: rank-merge batch keys into the pool, rebuild offsets.
    ``batch`` is a FlatCTree of packed keys (sorted, deduped, padded);
    ``n_out`` grows the vertex count when the batch names new sources."""
    pool = fct.FlatCTree(g.keys, g.m, g.weights)
    merged = fct.union_merge(pool, batch, out_cap)
    n = g.n if n_out is None else n_out
    return FlatGraph(
        _offsets_from_keys(merged.data, merged.n, n), merged.data, merged.n, merged.vals
    )


def delete_edges(g: FlatGraph, batch: fct.FlatCTree, out_cap: int) -> FlatGraph:
    pool = fct.FlatCTree(g.keys, g.m, g.weights)
    out = fct.difference(pool, batch, out_cap)
    return FlatGraph(_offsets_from_keys(out.data, out.n, g.n), out.data, out.n, out.vals)


def insert_edges_device(
    g: FlatGraph,
    batch: fct.FlatCTree,
    out_cap: int | None = None,
    *,
    n_out: int | None = None,
) -> FlatGraph:
    """Host-free InsertEdges: ``batch`` is already on the device (see
    ``fct.from_device``).  ``out_cap=None`` reads two device scalars to
    size the output exactly, which waits for the previous merge;
    pipelines pass ``out_cap`` from host-tracked counts, as
    ``AspenStream`` does."""
    if out_cap is None:
        out_cap = max(g.edge_capacity, fct.grown_capacity(int(g.m) + int(batch.n)))
    return insert_edges(g, batch, out_cap, n_out)


def delete_edges_device(
    g: FlatGraph, batch: fct.FlatCTree, out_cap: int | None = None
) -> FlatGraph:
    """Host-free DeleteEdges."""
    return delete_edges(g, batch, g.edge_capacity if out_cap is None else out_cap)


def batch_from_edges(
    edges: np.ndarray, cap: int | None = None, weights: np.ndarray | None = None, device=None
) -> fct.FlatCTree:
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    keys = (edges[:, 0] << 32) | edges[:, 1]
    return fct.from_array(keys, cap=cap, dtype=torch.int64, vals=weights, device=device)


def insert_edges_host(
    g: FlatGraph, edges: np.ndarray, weights: np.ndarray | None = None
) -> FlatGraph:
    """Host-driven insert with the capacity policy (quantized growth).  A
    weighted batch against an unweighted pool upgrades the pool to unit
    weights first (insert overwrites the weight of an existing edge)."""
    if weights is not None and g.weights is None:
        g = with_unit_weights(g)
    batch = batch_from_edges(edges, weights=weights, device=g.device)
    need = int(g.m) + int(batch.n)
    cap = max(g.edge_capacity, fct.grown_capacity(need))
    return insert_edges(g, batch, cap)


def delete_edges_host(g: FlatGraph, edges: np.ndarray) -> FlatGraph:
    batch = batch_from_edges(edges, device=g.device)
    return delete_edges(g, batch, g.edge_capacity)


# ---------------------------------------------------------------------------
# compressed pool: the paper's bytes-per-edge layout, on the device
# ---------------------------------------------------------------------------


class CompressedPool(NamedTuple):
    """FlatGraph with the dst lane chunk-compressed (paper §3.2).

    Same CSR contract as FlatGraph — ``offsets`` indexes the sorted pool,
    ``m`` counts the valid prefix — but src ids are implied by
    ``offsets`` and dst ids are a ``compressed.ChunkedStream``.
    ``weights`` stays a raw float32 lane padded to the chunked capacity.
    Updates decompress, rank-merge and recompress
    (``insert_edges_compressed``): the raw pool exists only inside the
    update step; the resident state is always compressed.
    """

    offsets: torch.Tensor  # int32[n+1] CSR offsets (valid prefix of pool)
    dst: cz.ChunkedStream  # chunked dst per pool slot; length = capacity
    m: torch.Tensor  # int32 0-dim: valid edge count
    weights: Optional[torch.Tensor] = None  # float32[cap] per-edge values (pad 0)

    @property
    def n(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def edge_capacity(self) -> int:
        return self.dst.length

    @property
    def device(self) -> torch.device:
        return self.offsets.device


def compressed_from_state(offsets, dst, m, weights=None, device=None) -> CompressedPool:
    """The port's CompressedPool from the reference's leaves as numpy
    arrays; ``dst`` is the stream's leaves in ``ChunkedStream`` order."""
    dev = resolve(device)
    return CompressedPool(
        torch.from_numpy(np.array(offsets, dtype=np.int32)).to(dev),
        cz.from_state(*dst, device=dev),
        torch.tensor(int(m), dtype=torch.int32, device=dev),
        None if weights is None else torch.from_numpy(np.array(weights, np.float32)).to(dev),
    )


def src_from_offsets(offsets: torch.Tensor, cap: int) -> torch.Tensor:
    """Per-slot src ids from CSR offsets (slot j belongs to the vertex
    whose offset range contains j); slots past offsets[n] map to n."""
    slots = torch.arange(cap, dtype=offsets.dtype, device=offsets.device)
    return (torch.searchsorted(offsets, slots, right=True) - 1).to(torch.int32)


def compress(g: FlatGraph, width: int = 2, k: int = cz.OVF_SLOTS,
             hi_cap: int | None = None) -> CompressedPool:
    """FlatGraph -> CompressedPool (lane width / escape capacity;
    ``hi_cap`` selects the adaptive layout and ignores ``width``).  No
    spill check: ``compress_host`` is the checked build."""
    cap = g.edge_capacity
    _, dst = unpack(g.keys)
    # Pad slots hold SENT64 (dst decodes to -1); encoding that cliff would
    # waste an escape per boundary chunk, so the last valid dst is carried
    # forward instead — decompress masks pad slots from ``m`` anyway.
    last = dst[torch.clamp(g.m.long() - 1, min=0)]
    dst_enc = torch.where(torch.arange(cap, device=g.device) < g.m, dst, last)
    if hi_cap is None:
        stream = cz.encode_stream(dst_enc, width=width, k=k)
    else:
        stream = cz.encode_stream_adaptive(dst_enc, hi_cap=hi_cap, k=k)
    w = g.weights
    if w is not None and stream.length > cap:
        w = torch.cat([w, w.new_zeros(stream.length - cap)])
    return CompressedPool(g.offsets, stream, g.m.to(torch.int32), w)


def decompress(cg: CompressedPool) -> FlatGraph:
    """CompressedPool -> FlatGraph (the exact inverse of ``compress`` on
    streams that did not spill; pad slots come back as SENT64)."""
    cap = cg.edge_capacity
    dst = cz.decode_stream(cg.dst)
    src = src_from_offsets(cg.offsets, cap)
    packed = (src.to(torch.int64) << 32) | (dst.to(torch.int64) & 0xFFFFFFFF)
    keys = torch.where(torch.arange(cap, device=cg.device) < cg.m, packed, SENT64)
    return FlatGraph(cg.offsets, keys, cg.m, cg.weights)


def compress_host(g: FlatGraph, width: int | None = None, k: int = cz.OVF_SLOTS,
                  hi_headroom: float = 0.0) -> CompressedPool:
    """Checked build: compress with width selection and one host read of
    the spill flag.

    ``width=None`` (the default) builds the adaptive layout: encode once
    with a full-capacity hi plane, then cut the plane to exactly the
    wide-chunk count, so resident bytes equal
    ``chunk_stats(g)["bytes_ideal"]``.  ``hi_headroom`` reserves extra hi
    rows as a fraction of the chunk count, so streaming updates can widen
    chunks without spilling.  ``width=1|2`` pins the fixed layout.
    Raises ``ValueError`` if the stream spills either way: the caller
    keeps the raw pool; nothing is silently corrupted.
    """
    if width is None:
        R = (max(g.edge_capacity, 1) + cz.CHUNK - 1) // cz.CHUNK
        cg = compress(g, k=k, hi_cap=R)
        if bool(cg.dst.spill):
            raise ValueError(
                f"graph spills the k={k} escape lane even at adaptive "
                "(int16-wide) chunks; keep the raw pool (delta gaps "
                "exceed the chunk escape budget)"
            )
        n_wide = int(cg.dst.wide.sum())
        hi_cap = n_wide
        if hi_headroom > 0.0:
            hi_cap = min(R, n_wide + max(4, int(np.ceil(hi_headroom * R))))
        return cg._replace(dst=cg.dst._replace(hi=cg.dst.hi[:hi_cap].clone()))
    cg = compress(g, width=width, k=k)
    if bool(cg.dst.spill):
        raise ValueError(
            f"graph spills the k={k} escape lane at width={width} deltas; "
            "keep the raw pool (delta gaps exceed the chunk escape budget)"
        )
    return cg


def with_unit_weights_compressed(cg: CompressedPool) -> CompressedPool:
    """Compressed counterpart of ``with_unit_weights``."""
    if cg.weights is not None:
        return cg
    return cg._replace(weights=torch.ones(cg.edge_capacity, dtype=torch.float32,
                                          device=cg.device))


def _recompress(g2: FlatGraph, cg: CompressedPool) -> CompressedPool:
    """Re-encode an updated pool with the input stream's lane width (or
    hi capacity) and escape capacity; the spill flag stays set once set."""
    hi_cap = cg.dst.hi_cap if cg.dst.adaptive else None
    out = compress(g2, cg.dst.width, cg.dst.k, hi_cap)
    return out._replace(dst=out.dst._replace(spill=out.dst.spill | cg.dst.spill))


def insert_edges_compressed(cg: CompressedPool, batch: fct.FlatCTree, out_cap: int,
                            n_out: int | None = None) -> CompressedPool:
    """InsertEdges on the compressed pool: decompress, rank-merge,
    recompress (adaptive streams re-select each chunk's width)."""
    return _recompress(insert_edges(decompress(cg), batch, out_cap, n_out), cg)


def delete_edges_compressed(cg: CompressedPool, batch: fct.FlatCTree,
                            out_cap: int) -> CompressedPool:
    """DeleteEdges on the compressed pool (see ``insert_edges_compressed``)."""
    return _recompress(delete_edges(decompress(cg), batch, out_cap), cg)


def chunk_stats(g: FlatGraph, *, b: int = cz.CHUNK, seed: int = 0,
                k: int = cz.OVF_SLOTS) -> dict:
    """Host statistics of the compressed layout: canonical (hash-head)
    chunk count beside the fixed-geometry chunks the device layout uses,
    per-chunk delta widths, escape counts, and ``bytes_ideal``, the exact
    resident byte count of ``compress_host(g)`` (anchors 4 + lane CHUNK +
    wide tag 1 + escape slots 8k per chunk, plus CHUNK hi bytes per wide
    chunk)."""
    heads = chunk_structure(g, b, seed).cpu().numpy()
    m = int(g.m)
    cap = g.edge_capacity
    # low 32 bits viewed as int32 (matching ``unpack``), widened
    dst = (g.keys.cpu().numpy() & 0xFFFFFFFF).astype(np.uint32).view(np.int32).astype(np.int64)
    if m > 0:
        dst[m:] = dst[m - 1]  # the encoder's carry-forward pad
    else:
        dst[:] = 0
    capC = ((max(cap, 1) + cz.CHUNK - 1) // cz.CHUNK) * cz.CHUNK
    dstp = np.concatenate([dst, np.full(capC - cap, dst[-1] if cap else 0, np.int64)])
    rows = dstp.reshape(-1, cz.CHUNK)
    absd = np.abs(np.diff(rows, axis=1, prepend=rows[:, :1]))
    chunk_max = absd.max(axis=1) if rows.size else np.zeros(0, np.int64)
    width_per_chunk = np.where(chunk_max <= 127, 1, np.where(chunk_max <= 32767, 2, 4))
    esc8 = (absd > 127).sum(axis=1)
    esc16 = (absd > 32767).sum(axis=1)
    R = rows.shape[0]
    ovf_bytes = 2 * 4 * k  # pos + add lanes, int32
    n_wide = int((esc8 > k).sum())
    return {
        "canonical_chunks": int(heads.sum()),
        "fixed_chunks": R,
        "max_abs_delta": int(chunk_max.max()) if R else 0,
        "width_per_chunk": width_per_chunk,
        "escapes_i8": int(esc8.sum()),
        "escapes_i16": int(esc16.sum()),
        "spill_i8": bool((esc8 > k).any()),
        "spill_i16": bool((esc16 > k).any()),
        "bytes_fixed": {w: R * (4 + w * cz.CHUNK + ovf_bytes) for w in (1, 2)},
        "n_wide": n_wide,
        "bytes_ideal": int(R * (4 + cz.CHUNK + 1 + ovf_bytes) + n_wide * cz.CHUNK),
    }
