"""The functional collectives a step on DTensors issues, by the
reference's HLO kind names, and the record a dispatch mode keeps of
each (``dist.spmd.SpmdMode`` records them; ``launch.hlo_analysis`` adds
up their bytes)."""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

_NAMESPACES = ("_c10d_functional", "c10d_functional", "_dtensor")

# functional collective -> the reference's HLO kind name
KIND_OF = {
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
    return KIND_OF.get(func._opname)
