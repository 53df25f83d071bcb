"""Sharding rules: config -> partition-spec trees for every cell family.

Counterpart of ``repro/dist/shardings.py``: the same rules, names and
divisibility guards, as pure functions of (config, mesh shape).  The only
mesh property consulted is its axis sizes (``axis_sizes``): a
``DeviceMesh`` gives them from ``mesh_dim_names`` and ``shape``, and any
object whose ``shape`` is an axis-name -> size mapping (a fake mesh in
the tests) gives them directly.  So the rules serve the dry run's
256/512-rank fake meshes and the 1x1 tests alike.

Conventions
-----------
* data-parallel ("batch") axes are ``pod`` and ``data`` when present;
  ``model`` is the tensor-parallel axis.
* every rule guards on divisibility: a dimension that does not divide
  by its target axis size is left replicated rather than producing an
  uneven shard (the memory model would lie).
* a spec is a ``Spec`` (alias ``P``): one entry per tensor dim, each
  ``None``, an axis name, or a tuple of axis names; trees of specs walk in
  the port's ``_tree`` order, a ``Spec`` being a leaf.  ``placements``
  turns a spec into ``torch.distributed.tensor`` placements on a
  ``DeviceMesh`` (the reference's ``named``); ``shard_of`` / ``place``
  take a rank's slice out of a logical tensor (tree) by those placements
  on a real mesh, ``gather_shard`` / ``gather`` put the slices together
  again across the ranks, on every rank, and ``gather_to_rank0`` on rank
  0's host only.  A rank's slice is the local shard DTensor lays out for
  the same placements on any ``(d, m)`` mesh (a dim named by several mesh
  dims splits major first), so ``dist.spmd.from_local`` wraps it and a
  DTensor's ``to_local`` is it; the gathers take either.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np

from .._tree import _is_namedtuple


class Spec:
    """A partition spec: ``Spec(None, "model")`` shards dim 1 over the
    ``model`` axis; an entry that is a tuple of names shards its dim over
    all of them, major first.  Dims past the last entry are replicated."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        # a tuple of one name is that name and an empty one None, as the
        # reference's PartitionSpec stores them
        self.entries = tuple(
            (e[0] if len(e) == 1 else (e or None)) if isinstance(e, tuple) else e
            for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, Spec):
            return self.entries == other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"Spec{self.entries!r}"


P = Spec


def axis_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size of ``mesh`` (a ``DeviceMesh`` or a fake mesh)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names:
        return dict(zip(names, (int(s) for s in mesh.shape)))
    shape = mesh.shape
    if not isinstance(shape, Mapping):
        raise TypeError("a mesh needs named axes (mesh_dim_names, or a mapping shape)")
    return {k: int(v) for k, v in shape.items()}


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def batch_axes(mesh) -> Tuple[str, ...]:
    """The data-parallel axes of ``mesh`` (everything but ``model``)."""
    sizes = axis_sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in sizes)


def _batch_size_of(mesh) -> int:
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in batch_axes(mesh)], dtype=np.int64)) or 1


def _batch_entry(mesh):
    """Spec entry for a batch-sharded dim, or None if no batch axes."""
    bax = batch_axes(mesh)
    return tuple(bax) if bax else None


def placements(mesh, spec: Optional[Spec]):
    """``spec`` as DTensor placements on the ``DeviceMesh`` ``mesh``:
    ``Shard(d)`` on each mesh dim that ``spec`` names at tensor dim ``d``,
    ``Replicate()`` on the rest (``None`` replicates everything).  A mesh
    dim named ``"a+b"`` stands for axes a and b flattened (the dry run's
    ``spmd_mesh``)."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {}
    for d, entry in enumerate(spec or ()):
        for name in _names(entry):
            dim_of[name] = d
    out = []
    for dim_name in mesh.mesh_dim_names:
        # a flattened mesh dim ("pod+data") is sharded where all of its
        # axes are named together
        dims = {dim_of.get(name) for name in dim_name.split("+")}
        if len(dims) != 1:
            raise ValueError(f"{spec} splits the flattened mesh dim {dim_name!r}")
        d = dims.pop()
        out.append(Replicate() if d is None else Shard(d))
    return tuple(out)


def shard_of(t, spec: Optional[Spec], mesh, coord=None):
    """This rank's slice of the logical tensor ``t`` laid out by ``spec``
    on the ``DeviceMesh`` ``mesh`` (or the slice of the rank at mesh
    coordinate ``coord``): for each mesh dim that ``placements`` shards,
    the coordinate's share of equal chunks of that tensor dim, mesh dims
    in order (a tuple entry shards major first, as DTensor and the
    reference lay it out).  A dim that does not divide evenly raises (the
    rules leave such dims replicated).  A view of ``t``: ``place`` copies
    it out."""
    coord = mesh.get_coordinate() if coord is None else coord
    out = t
    for i, pl in enumerate(placements(mesh, spec)):
        k = int(mesh.size(i))
        if not pl.is_shard() or k == 1:
            continue
        if out.shape[pl.dim] % k:
            raise ValueError(f"dim {pl.dim} of {tuple(t.shape)} does not split into {k} "
                             f"shards ({spec})")
        c = out.shape[pl.dim] // k
        out = out.narrow(pl.dim, int(coord[i]) * c, c)
    return out


def is_sharded(spec: Optional[Spec], mesh) -> bool:
    """Whether ``spec`` splits a tensor over some mesh dim of more than one
    rank."""
    return any(pl.is_shard() and int(mesh.size(i)) > 1
               for i, pl in enumerate(placements(mesh, spec)))


def gather_to_rank0(local, spec: Optional[Spec], mesh):
    """The logical tensor of which ``local`` is this rank's ``shard_of``,
    on the host of global rank 0 (None on every other rank): every rank
    calls it, each sends its slice to rank 0 in one ``gather`` over the
    default group, and no rank but 0 ever holds the whole tensor (a
    checkpoint's write)."""
    import torch
    import torch.distributed as dist

    rank = dist.get_rank()
    local = _local_of(local)
    if not is_sharded(spec, mesh):
        return local.detach().cpu() if rank == 0 else None
    x = local.detach().contiguous()
    if x.is_cuda and dist.get_backend() == "gloo":
        x = x.cpu()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())] if rank == 0 else None
    dist.gather(x, parts, dst=0)
    if rank != 0:
        return None
    shape = list(x.shape)
    for i, pl in enumerate(placements(mesh, spec)):
        if pl.is_shard():
            shape[pl.dim] *= int(mesh.size(i))
    out = torch.empty(shape, dtype=x.dtype)
    layout = mesh.mesh
    for r, part in enumerate(parts):
        coord = [int(c) for c in (layout == r).nonzero()[0]]
        shard_of(out, spec, mesh, coord).copy_(part)
        parts[r] = None  # each slice leaves the card as it is placed
    return out


def place(tree, specs, mesh):
    """Each leaf of ``tree`` (logical tensors) as this rank's slice by the
    spec tree ``specs`` on ``mesh``, in its own memory."""
    return map_specs(lambda sp, t: shard_of(t, sp, mesh).clone(), specs, tree)


def _all_gather_dim(t, dim: int, group):
    """``t``'s pieces from every rank of ``group`` joined along ``dim``, in
    rank order (through host memory where gloo holds CUDA tensors)."""
    import torch.distributed as dist

    k = dist.get_world_size(group)
    x = t.movedim(dim, 0).contiguous()
    host = x.is_cuda and dist.get_backend(group) == "gloo"
    src = x.cpu() if host else x
    out = src.new_empty((k * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    return out.to(t.device).movedim(0, dim).contiguous() if host or dim else out


def _local_of(t):
    """A DTensor's local shard (what ``shard_of`` gives on its mesh by its
    placements), a plain tensor as it is."""
    from .spmd import is_dtensor

    return t.to_local() if is_dtensor(t) else t


def gather_shard(local, spec: Optional[Spec], mesh):
    """The logical tensor of which ``local`` is this rank's ``shard_of``:
    every rank calls it, and each sharded mesh dim is all-gathered (minor
    first)."""
    out = _local_of(local)
    pls = placements(mesh, spec)
    for i in reversed(range(len(pls))):
        if pls[i].is_shard() and int(mesh.size(i)) > 1:
            out = _all_gather_dim(out, pls[i].dim, mesh.get_group(i))
    return out


def gather(tree, specs, mesh):
    """``gather_shard`` over a tree: the logical tree from every rank's
    slices (every rank calls it and gets all of it)."""
    return map_specs(lambda sp, t: gather_shard(t, sp, mesh), specs, tree)


def spec_to_json(spec: Optional[Spec]):
    """The reference's manifest form of a spec: ``list(P)``, a tuple entry
    as a list of names; None stays None."""
    if spec is None:
        return None
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def spec_from_json(entries) -> Optional[Spec]:
    return None if entries is None else P(*(tuple(e) if isinstance(e, list) else e
                                            for e in entries))


def local_shape(shape, spec: Optional[Spec], mesh) -> Tuple[int, ...]:
    """The shape of rank 0's shard of a ``shape`` tensor laid out by
    ``spec`` (the largest shard: an uneven dim rounds up)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec or ()):
        k = int(np.prod([sizes[a] for a in _names(entry)], dtype=np.int64))
        out[d] = -(-out[d] // k) if k > 1 else out[d]
    return tuple(out)


def map_specs(fn, specs, tree):
    """``fn(spec, leaf)`` over a spec tree and a tree of its structure."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, specs[k], v) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_specs(fn, s, v) for s, v in zip(specs, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, s, v) for s, v in zip(specs, tree))
    if tree is None:
        return None
    return fn(specs, tree)


def map_leaves(fn, tree):
    """``fn(leaf)`` over ``tree``'s leaves, keeping its structure."""
    return map_specs(lambda _s, t: fn(t), tree, tree)


def spec_tree_like(specs, tree):
    """Reconcile a (possibly partial) spec tree against a param tree:
    keys missing from ``specs`` are replicated; keys in ``specs`` that
    the params don't have are dropped (e.g. optional qkv biases)."""

    def rec(sp, t):
        if isinstance(t, dict):
            sub = sp if isinstance(sp, dict) else {}
            return {k: rec(sub.get(k), v) for k, v in t.items()}
        if isinstance(t, (list, tuple)) and not hasattr(t, "shape"):
            if isinstance(sp, (list, tuple)) and len(sp) == len(t):
                out = [rec(s, v) for s, v in zip(sp, t)]
            else:
                out = [rec(None, v) for v in t]
            return type(t)(out) if isinstance(t, tuple) else out
        return sp if isinstance(sp, Spec) else P()

    return rec(specs, tree)


def replicated_like(tree):
    """A spec tree of ``tree``'s structure that replicates every leaf."""
    return map_leaves(lambda _: P(), tree)


def zero1_specs(specs, params, mesh):
    """ZeRO-1 optimizer-state sharding: additionally shard each leaf's
    largest *free* (currently-replicated) dim over the batch axes, when
    it divides evenly; otherwise leave the spec unchanged."""
    bax = batch_axes(mesh)
    nb = _batch_size_of(mesh)
    if not bax:
        return specs
    entry = bax[0] if len(bax) == 1 else tuple(bax)

    def one(sp, p):
        shape = tuple(p.shape)
        entries = list(sp) + [None] * (len(shape) - len(sp))
        free = [i for i, e in enumerate(entries) if e is None and shape[i] % nb == 0]
        if not free or nb <= 1:
            return sp
        i = max(free, key=lambda i: shape[i])
        entries[i] = entry
        return P(*entries)

    return map_specs(one, specs, params)


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------


def lm_param_specs(cfg, mesh) -> Dict[str, Any]:
    """Megatron-style tensor parallelism over the ``model`` axis, with
    divisibility guards (a head/ff/vocab count that doesn't divide the
    axis stays replicated).  Layer params carry a leading stacked-layer
    dim, hence the extra None."""
    nm = axis_sizes(mesh)["model"]
    h_ok = cfg.n_heads % nm == 0
    kv_ok = cfg.n_kv_heads % nm == 0
    ff_ok = cfg.d_ff % nm == 0

    def r(k):
        return P(*([None] * k))

    attn = {
        "wq": P(None, None, "model", None) if h_ok else r(4),
        "wk": P(None, None, "model", None) if kv_ok else r(4),
        "wv": P(None, None, "model", None) if kv_ok else r(4),
        "wo": P(None, "model", None, None) if h_ok else r(4),
        # optional biases (dropped by spec_tree_like when absent)
        "bq": P(None, "model", None) if h_ok else r(3),
        "bk": P(None, "model", None) if kv_ok else r(3),
        "bv": P(None, "model", None) if kv_ok else r(3),
    }
    if cfg.moe is None:
        mlp = {
            "w_up": P(None, None, "model") if ff_ok else r(3),
            "w_down": P(None, "model", None) if ff_ok else r(3),
        }
        if cfg.mlp_kind != "gelu":
            mlp["w_gate"] = P(None, None, "model") if ff_ok else r(3)
    else:
        e_ok = cfg.moe.n_experts % nm == 0
        mlp = {
            "router": r(3),
            "w_gate": P(None, "model", None, None) if e_ok else r(4),
            "w_up": P(None, "model", None, None) if e_ok else r(4),
            "w_down": P(None, "model", None, None) if e_ok else r(4),
        }
        if cfg.moe.n_shared > 0:
            sh_ok = (cfg.moe.shared_d_ff * cfg.moe.n_shared) % nm == 0
            mlp["shared"] = {
                "w_gate": P(None, None, "model") if sh_ok else r(3),
                "w_up": P(None, None, "model") if sh_ok else r(3),
                "w_down": P(None, "model", None) if sh_ok else r(3),
            }
    norm = {"scale": P(None), "bias": P(None)}
    return {
        "embed": {"table": P("model", None) if cfg.vocab % nm == 0 else r(2)},
        "layers": {"attn": attn, "ln1": norm, "ln2": norm, "mlp": mlp},
        "ln_f": norm,
    }


def lm_data_specs(mesh) -> Dict[str, Spec]:
    b = _batch_entry(mesh)
    return {"tokens": P(b, None), "labels": P(b, None)}


def lm_cache_specs(
    cfg,
    mesh,
    seq_shard: bool = False,
    batch_size: Optional[int] = None,
    seq_axes: Sequence[str] = ("model",),
) -> Dict[str, Spec]:
    """KV-cache specs for decode: (L, B, S, KV, HD).

    Batch shards over the data axes only when it divides (and B > 1);
    ``seq_shard`` moves the model axis onto the sequence dim for configs
    whose kv-head count doesn't divide it (or single-sequence shapes).
    """
    bax = batch_axes(mesh)
    nb = _batch_size_of(mesh)
    b = None
    if bax and batch_size is not None and batch_size > 1 and batch_size % nb == 0:
        b = tuple(bax)
    nm = axis_sizes(mesh)["model"]
    kv_ok = cfg.n_kv_heads % nm == 0
    if seq_shard:
        kv = P(None, b, tuple(seq_axes), None, None)
    else:
        kv = P(None, b, None, "model" if kv_ok else None, None)
    return {"k": kv, "v": kv, "len": P(b)}


def decode_cache_seq_shard(cfg, mesh, batch: int) -> bool:
    """Whether a decode's kv cache shards its sequence (``lm_cache_specs``'
    ``seq_shard``): where the kv heads do not divide the model axis, and
    always for one sequence, as the reference's decode cell chooses."""
    return cfg.n_kv_heads % axis_sizes(mesh)["model"] != 0 or batch == 1


# ---------------------------------------------------------------------------
# GNN family
# ---------------------------------------------------------------------------


def gnn_batch_specs(mesh, shard_nodes: bool = False) -> Dict[str, Spec]:
    """Full-graph GNN batches: edges shard over the batch axes (they're
    padded to 512-multiples by the cell builders); node arrays shard
    over ``model`` only for the large-graph cells."""
    e = _batch_entry(mesh)
    node = P("model", None) if shard_nodes else P(None, None)
    nmask = P("model") if shard_nodes else P(None)
    return {
        "x": node,
        "src": P(e),
        "dst": P(e),
        "edge_mask": P(e),
        "node_mask": nmask,
        "edge_attr": P(e, None),
        "graph_ids": nmask,
    }


def sage_sampled_specs(mesh) -> Dict[str, Any]:
    b = _batch_entry(mesh)
    return {
        "x_self": P(b, None),
        "neigh_feats": [P(b, None, None), P(b, None, None, None)],
        "neigh_masks": [P(b, None), P(b, None, None)],
        "labels": P(b),
    }


# ---------------------------------------------------------------------------
# recsys family
# ---------------------------------------------------------------------------


def dcn_param_specs(params_shape, mesh):
    """DCN-v2: the embedding tables (n_fields, vocab, dim) dominate —
    shard the vocab dim over ``model`` when it divides; everything else
    (cross layers, MLPs) is small and stays replicated."""
    nm = axis_sizes(mesh).get("model", 1)

    def one(p):
        shape = tuple(p.shape)
        if len(shape) == 3 and shape[1] >= 1024:
            return P(None, "model", None) if shape[1] % nm == 0 else P()
        return P()

    return map_leaves(one, params_shape)
