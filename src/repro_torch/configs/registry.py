"""Architecture registry: the 10 assigned archs and the paper's own
config, ``LM_SHAPES``, ``GNNConfig``, ``GNN_SHAPES``, ``RECSYS_SHAPES``,
``DCNConfig``, ``STREAM_SHAPES``, ``StreamConfig``, ``ArchSpec``, ``get``
and ``all_cells`` (the dry run's cell list).

Counterpart of ``repro/configs/registry.py``.
``aspen-stream`` is the paper's own configuration.  Each config module
defines FULL (the assigned numbers), REDUCED (smoke scale) and the shape
set of its family.  The LM configs are ``models.transformer.LMConfig``s.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Any, Dict, Tuple

LM_SHAPES: Dict[str, Dict[str, int]] = {
    "train_4k": {"seq_len": 4096, "global_batch": 256, "kind": "train"},
    "prefill_32k": {"seq_len": 32768, "global_batch": 32, "kind": "prefill"},
    "decode_32k": {"seq_len": 32768, "global_batch": 128, "kind": "decode"},
    "long_500k": {"seq_len": 524288, "global_batch": 1, "kind": "decode"},
}

GNN_SHAPES: Dict[str, Dict[str, Any]] = {
    "full_graph_sm": {
        "n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "kind": "full",
    },
    "minibatch_lg": {
        "n_nodes": 232_965, "n_edges": 114_615_892, "batch_nodes": 1024,
        "fanout": (15, 10), "d_feat": 602, "kind": "sampled",
    },
    "ogb_products": {
        "n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100, "kind": "full_large",
    },
    "molecule": {
        "n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 16, "kind": "batched_small",
    },
}

RECSYS_SHAPES: Dict[str, Dict[str, Any]] = {
    "train_batch": {"batch": 65_536, "kind": "train"},
    "serve_p99": {"batch": 512, "kind": "serve"},
    "serve_bulk": {"batch": 262_144, "kind": "serve"},
    "retrieval_cand": {"batch": 1, "n_candidates": 1_000_000, "kind": "retrieval"},
}

STREAM_SHAPES: Dict[str, Dict[str, Any]] = {
    "update_2m": {"pool_edges": 1 << 28, "batch_edges": 1 << 21, "n_nodes": 1 << 25, "kind": "update"},
    "query_bfs": {"pool_edges": 1 << 28, "n_nodes": 1 << 25, "kind": "query"},
    "decode_pool": {"pool_edges": 1 << 28, "n_nodes": 1 << 25, "kind": "decode"},
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str  # lm | gnn | recsys | stream
    full: Any  # family config object (exact assigned numbers)
    reduced: Any  # smoke-scale config
    shapes: Dict[str, Dict[str, Any]]
    notes: str = ""


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    name: str
    kind: str  # gcn | graphsage | schnet | graphcast
    n_layers: int
    d_hidden: int
    aggregator: str = "mean"
    # arch-specific extras
    sample_sizes: Tuple[int, ...] = ()
    n_rbf: int = 0
    cutoff: float = 0.0
    mesh_refinement: int = 0
    n_vars: int = 0
    n_classes: int = 64


@dataclasses.dataclass(frozen=True)
class DCNConfig:
    name: str
    n_dense: int = 13
    n_sparse: int = 26
    embed_dim: int = 16
    n_cross: int = 3
    mlp_dims: Tuple[int, ...] = (1024, 1024, 512)
    vocab_per_field: int = 1_000_000
    n_candidates: int = 1_000_000


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    name: str
    b: int = 256
    seed: int = 0x9E3779B9


ARCH_IDS = [
    "smollm-360m",
    "qwen2.5-3b",
    "starcoder2-7b",
    "qwen3-moe-30b-a3b",
    "deepseek-moe-16b",
    "graphsage-reddit",
    "gcn-cora",
    "schnet",
    "graphcast",
    "dcn-v2",
    "aspen-stream",  # the paper's own configuration (extra, not a cell)
]

_MODULE_OF = {a: a.replace("-", "_").replace(".", "_") for a in ARCH_IDS}


def get(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULE_OF:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULE_OF[arch_id]}")
    return mod.SPEC


def all_cells(include_stream: bool = False):
    """Yield every (arch_id, shape_name) dry-run cell (40 assigned)."""
    for a in ARCH_IDS:
        if a == "aspen-stream" and not include_stream:
            continue
        spec = get(a)
        for s in spec.shapes:
            yield a, s
