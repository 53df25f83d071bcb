"""Collective-byte accounting over the collectives a run recorded.

Counterpart of ``repro/launch/hlo_analysis.py``.  The reference parses
the text of XLA's compiled HLO and sums the result-shape bytes of every
collective op; after SPMD partitioning those shapes are per-device
shards.  The port compiles nothing, so there is no HLO text to parse:
the dry run executes the step eagerly on a ``fake`` process group, and
its dispatch mode records every functional collective that DTensor
issues (the ``_c10d_functional`` / ``c10d_functional`` ops, and
``_dtensor.shard_dim_alltoall`` for a shard moved between dims) with its
result on the local shard and the ranks of its group.  This module adds
those up under the reference's kind names, counting each result's
per-rank bytes as the reference counts result shapes after SPMD.
"""
from __future__ import annotations

from typing import Dict, Iterable, NamedTuple, Optional, Sequence, Tuple

import torch

from . import mesh as mesh_lib

_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")

# functional collective -> the reference's HLO kind name
_KIND_OF = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",  # DTensor's shard-to-shard move
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
}


class Collective(NamedTuple):
    """One recorded collective: its functional op name, its result on
    this rank (a tensor or a list of them) and the ranks of its group."""

    op: str
    result: object
    ranks: Tuple[int, ...] = ()


def kind_of(func) -> Optional[str]:
    """The reference's kind name of a dispatched op, None for an op that
    moves no bytes between ranks (``wait_tensor`` included)."""
    if getattr(func, "namespace", None) not in _NAMESPACES:
        return None
    return _KIND_OF.get(func._opname)


def _nbytes(result) -> int:
    if isinstance(result, torch.Tensor):
        return result.numel() * result.element_size()
    if isinstance(result, (list, tuple)):
        return sum(_nbytes(r) for r in result)
    return 0


def collective_bytes(records: Iterable[Collective]):
    """Sum the per-rank result bytes of every recorded collective.
    Returns (total, per-kind)."""
    per_kind: Dict[str, int] = {}
    total = 0
    for rec in records:
        kind = _KIND_OF.get(rec.op, rec.op)
        b = _nbytes(rec.result)
        total += b
        per_kind[kind] = per_kind.get(kind, 0) + b
    return total, per_kind


def bytes_by_link(records: Sequence[Collective]) -> Dict[str, int]:
    """Per-rank bytes split by the link that carries them
    (``mesh.link_of`` over each collective's group)."""
    out = {"nvlink": 0, "network": 0}
    for rec in records:
        out[mesh_lib.link_of(rec.ranks or (0,))] += _nbytes(rec.result)
    return out
