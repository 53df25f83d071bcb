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

from typing import Dict, Iterable, Sequence

import torch

from ..dist.collectives import KIND_OF, Collective
from . import mesh as mesh_lib


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
        kind = KIND_OF.get(rec.op, rec.op)
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
