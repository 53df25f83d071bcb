"""EmbeddingBag substrate for recsys.

Counterpart of ``repro/models/recsys/embedding.py:25-76``.  Two layouts:

  * one-hot fields (DCN / criteo): per-field tables stacked into one
    (n_fields, vocab, dim) tensor; a lookup is one gather of a row per
    (example, field);
  * multi-hot bags: flat (ids, offsets) CSR-style bags reduced by a
    segment sum (``index_add_``, the reference's ``segment_sum``) — and
    the bag indices can come straight from an Aspen flat C-tree pool (a
    streaming user->item interaction log), the paper's §9 "other
    applications" use made concrete (``bags_from_ctree_pool``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..._device import resolve
from .. import layers as L


def init_field_tables(gen: torch.Generator, n_fields: int, vocab_per_field: int, dim: int,
                      dtype=torch.float32, device=None) -> Dict[str, Any]:
    """``{"tables": (n_fields, vocab, dim)}``, N(0, 1/dim) draws from ``gen``."""
    return {"tables": L._normal(gen, (n_fields, vocab_per_field, dim), dim ** -0.5, dtype,
                                resolve(device))}


def lookup_onehot(params, ids: torch.Tensor) -> torch.Tensor:
    """ids: (B, F) one id per field -> (B, F, dim): field f reads table f."""
    tables = params["tables"]  # (F, V, D)
    fields = torch.arange(tables.shape[0], device=ids.device)
    return tables[fields[None, :], ids]


def lookup_bags(params, flat_ids: torch.Tensor, bag_offsets: torch.Tensor,
                field_of_bag: torch.Tensor, n_bags: int, op: str = "sum") -> torch.Tensor:
    """Multi-hot EmbeddingBag.

    flat_ids: (L,) item ids; bag_offsets: (n_bags+1,); field_of_bag:
    (n_bags,) which table each bag reads.  Returns (n_bags, D).  As the
    reference's ``jnp.repeat(..., total_repeat_length=L)``, id ``i``
    belongs to the bag whose span (counted from 0) holds it, and ids past
    the last span to the last bag.
    """
    tables = params["tables"]
    lens = torch.diff(bag_offsets)
    ends = torch.cumsum(lens, 0)
    pos = torch.arange(flat_ids.shape[0], device=flat_ids.device, dtype=ends.dtype)
    bag_of_id = torch.clamp(torch.searchsorted(ends, pos, right=True), max=n_bags - 1)
    field_of_id = field_of_bag[bag_of_id]
    vecs = tables[field_of_id, flat_ids]  # (L, D)
    s = vecs.new_zeros((n_bags, vecs.shape[1])).index_add_(0, bag_of_id, vecs)
    if op == "mean":
        s = s / torch.clamp(lens[:, None], min=1).to(s.dtype)
    return s


def bags_from_ctree_pool(pool_keys: torch.Tensor, m, n_users: int):
    """Interpret an Aspen flat C-tree pool of packed (user<<32|item) keys
    (a ``core.flat_graph.FlatGraph``'s ``keys`` and ``m``) as per-user
    bags: returns (int32 flat_item_ids, int32 bag_offsets (n_users+1,)).

    The zero-copy bridge: the streaming interaction log IS the
    EmbeddingBag input (paper §9: C-trees for dynamically-maintained
    ordered integer sets)."""
    items = (pool_keys & 0xFFFFFFFF).to(torch.int32)
    bounds = torch.arange(n_users + 1, dtype=torch.int64, device=pool_keys.device) << 32
    m = torch.as_tensor(m, device=pool_keys.device).to(torch.int64)
    offs = torch.minimum(torch.searchsorted(pool_keys, bounds), m).to(torch.int32)
    return items, offs
