"""Cell builders: (architecture x input-shape) -> a step and its inputs.

Counterpart of ``repro/launch/cells.py``.  Each cell yields:
  * ``step_fn``   — the function the shape dictates (train_step, prefill,
                    serve_step, GNN train, recsys serve, stream update, ...)
  * ``args``      — inputs on the meta device (the reference's
                    ``ShapeDtypeStruct``s; nothing is ever allocated:
                    parameters come from the port's ``init_*`` on meta)
  * ``in_specs`` / ``out_specs`` — ``dist.shardings.Spec`` trees of the
                    args and the outputs (``out_specs`` may be None)
  * ``meta``      — MODEL_FLOPS & friends for the roofline report.

Global shapes, dtypes' byte widths, padding and every ``meta`` figure
are the reference's (its ``_lm_mem_estimate`` included).  Padding
policy: dynamic dims (edge counts, node counts) are padded to multiples
of 512 so every mesh in play (16 / 256 / 512 ranks) divides them evenly;
padding is masked (``GraphBatch.edge_mask`` etc.).

Where the reference's builders take ``unroll`` (XLA's cost analysis
counts a while-loop body once, so it compiles unrolled probes), the port
has none: an eager run counts every layer.  Steps that read a value back
to the host cannot run on meta tensors, so the stream cells keep the
reference's fixed capacities (``out_cap``) and the query cell runs one
BFS round (``_bfs_round``), the loop body the reference's count sees.
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..configs import registry
from ..dist import shardings as SH
from ..dist.shardings import P
from ..models import transformer as T
from ..models.gnn.common import GraphBatch
from ..optim import adamw
from ..train import train_step as TS

META = torch.device("meta")


class Cell(NamedTuple):
    step_fn: Callable
    args: Tuple
    in_specs: Any
    out_specs: Any  # may be None (the run's own layout)
    meta: Dict[str, Any]


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _mesh_size(mesh, axes) -> int:
    sizes = SH.axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in axes], dtype=np.int64))


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------


def _lm_params(cfg):
    return T.init_params(None, cfg, device=META)


def _lm_state_specs(cfg, mesh, params_shape):
    p_specs = SH.spec_tree_like(SH.lm_param_specs(cfg, mesh), params_shape)
    z_m = SH.zero1_specs(p_specs, params_shape, mesh)
    z_v = SH.zero1_specs(p_specs, params_shape, mesh)
    return TS.TrainState(p_specs, adamw.AdamWState(P(), z_m, z_v))


def _lm_mem_estimate(cfg, mesh, B, S, kind: str) -> Dict[str, float]:
    """Analytic per-device memory model (bytes), the reference's formulas:
    params/grads/opt exact, activations = remat-saved residuals + one
    layer's transient working set."""
    sizes = SH.axis_sizes(mesh)
    n_model = sizes["model"]
    n_data = int(np.prod([v for k, v in sizes.items() if k != "model"]))
    P_total = cfg.param_count()
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    # params: embed shards over model (vocab), mlp/moe shard over model;
    # attn shards only when heads divide — approximate with the exact
    # replicated-attn correction.
    h_div = cfg.n_heads % n_model == 0
    attn_p = L * (d * (cfg.n_heads + 2 * cfg.n_kv_heads) * cfg.head_dim
                  + cfg.n_heads * cfg.head_dim * d)
    sharded_p = P_total - (0 if h_div else attn_p)
    p_dev = (sharded_p / n_model + (0 if h_div else attn_p)) * 2  # bf16
    if kind == "train":
        g_dev = p_dev * 2  # f32 grads, same sharding
        o_dev = (sharded_p / n_model + (0 if h_div else attn_p)) / max(n_data, 1) * 8
        toks_dev = B * S / n_data
        resid = L * toks_dev * d * 2  # remat=full: one bf16 residual/layer
        logits = toks_dev * V / n_model * 4
        transient = toks_dev * max(3 * cfg.d_ff / n_model, 4 * d) * 4
        total = p_dev + g_dev + o_dev + resid + logits + transient
        parts = dict(params=p_dev, grads=g_dev, opt=o_dev, resid=resid,
                     logits=logits, transient=transient)
    else:
        toks_dev = B * S / n_data if kind == "prefill" else B / n_data
        kv = 2 * L * B * S * cfg.n_kv_heads * cfg.head_dim * 2  # bf16 k+v
        kv_dev = kv / (n_data * n_model) if kind == "decode" else 0
        act = toks_dev * d * 2 * 4
        logits = (B / max(n_data, 1)) * V / n_model * 4
        total = p_dev + kv_dev + act + logits
        parts = dict(params=p_dev, kv=kv_dev, act=act, logits=logits)
    parts["total"] = total
    return {k: float(v) for k, v in parts.items()}


_METRICS_SPECS = {"loss": P(), "grad_norm": P(), "lr": P()}


def _lm_train_cell(cfg, shape, mesh, remat: Optional[str] = None, n_micro: int = 1) -> Cell:
    B, S = shape["global_batch"], shape["seq_len"]
    cfg = dataclasses.replace(cfg, remat=remat if remat is not None else "full")
    params_shape = _lm_params(cfg)
    state_shape = TS.init_state(params_shape)
    state_specs = _lm_state_specs(cfg, mesh, params_shape)
    batch = {"tokens": _sds((B, S), torch.int32), "labels": _sds((B, S), torch.int32)}
    b_specs = SH.lm_data_specs(mesh)
    step = TS.make_train_step(
        TS.lm_loss(cfg), adamw.wsd_schedule(100, 10_000, 1_000, 3e-4), n_micro=n_micro,
    )
    tokens = B * S
    n_active = cfg.active_param_count()
    meta = {
        "model_flops": 6.0 * n_active * tokens,
        "tokens": tokens,
        "params": cfg.param_count(),
        "active_params": n_active,
        "kind": "train",
        "n_layers": cfg.n_layers,
        "mem_model": _lm_mem_estimate(cfg, mesh, B, S, "train"),
    }
    return Cell(step, (state_shape, batch), (state_specs, b_specs),
                (state_specs, _METRICS_SPECS), meta)


def _lm_prefill_cell(cfg, shape, mesh) -> Cell:
    from ..serve import decode as SD

    B, S = shape["global_batch"], shape["seq_len"]
    params_shape = _lm_params(cfg)
    p_specs = SH.spec_tree_like(SH.lm_param_specs(cfg, mesh), params_shape)
    tokens = _sds((B, S), torch.int32)
    meta = {
        "model_flops": 2.0 * cfg.active_param_count() * B * S,
        "tokens": B * S,
        "params": cfg.param_count(),
        "kind": "prefill",
        "n_layers": cfg.n_layers,
        "mem_model": _lm_mem_estimate(cfg, mesh, B, S, "prefill"),
    }
    return Cell(SD.make_prefill(cfg), (params_shape, tokens),
                (p_specs, P(SH.batch_axes(mesh), None)), None, meta)


def _lm_decode_cell(cfg, shape, mesh, seq_axes=("model",)) -> Cell:
    from ..serve import decode as SD

    B, S = shape["global_batch"], shape["seq_len"]
    params_shape = _lm_params(cfg)
    p_specs = SH.spec_tree_like(SH.lm_param_specs(cfg, mesh), params_shape)
    cache_shape = T.init_kv_cache(cfg, B, S, device=META)
    seq_shard = SH.decode_cache_seq_shard(cfg, mesh, B)
    cache_specs = SH.lm_cache_specs(
        cfg, mesh, seq_shard=seq_shard, batch_size=B, seq_axes=seq_axes
    )
    token = _sds((B,), torch.int32)
    meta = {
        "model_flops": 2.0 * cfg.active_param_count() * B,
        "tokens": B,
        "params": cfg.param_count(),
        "kv_bytes": int(np.prod(cache_shape["k"].shape)) * 2 * 2,
        "kind": "decode",
        "seq_shard": seq_shard,
        "n_layers": cfg.n_layers,
        "mem_model": _lm_mem_estimate(cfg, mesh, B, S, "decode"),
    }
    b = SH.batch_axes(mesh)
    b_tok = b if B % _mesh_size(mesh, b) == 0 else None
    return Cell(SD.make_serve_step(cfg), (params_shape, cache_shape, token),
                (p_specs, cache_specs, P(b_tok)), None, meta)


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------


def _gnn_params(cfg: registry.GNNConfig, d_feat: int):
    if cfg.kind == "gcn":
        from ..models.gnn import gcn

        return gcn.init(None, d_feat, cfg.d_hidden, cfg.n_classes, cfg.n_layers, device=META)
    if cfg.kind == "graphsage":
        from ..models.gnn import graphsage

        return graphsage.init(None, d_feat, cfg.d_hidden, cfg.n_classes, cfg.n_layers,
                              device=META)
    if cfg.kind == "schnet":
        from ..models.gnn import schnet

        return schnet.init(None, d_feat, cfg.d_hidden, cfg.n_layers, cfg.n_rbf, device=META)
    if cfg.kind == "graphcast":
        from ..models.gnn import graphcast

        return graphcast.init(None, d_feat, cfg.d_hidden, cfg.n_layers, cfg.n_classes,
                              device=META)
    raise ValueError(cfg.kind)


def _gnn_flops(cfg: registry.GNNConfig, n: int, e: int, d_feat: int) -> float:
    """Matmul-dominated estimate (forward): node transforms + edge MLPs."""
    d = cfg.d_hidden
    if cfg.kind == "gcn":
        f = 2 * n * d_feat * d + (cfg.n_layers - 1) * 2 * n * d * d + 2 * e * d
    elif cfg.kind == "graphsage":
        f = cfg.n_layers * (4 * n * d * d) + 2 * n * d_feat * d + 2 * e * d
    elif cfg.kind == "schnet":
        # filter MLP per edge (rbf->d->d) + node projections
        f = cfg.n_layers * (2 * e * (cfg.n_rbf * d + d * d) + 4 * n * d * d)
    else:  # graphcast: edge MLP(3d->d->d) + node MLP(2d->d->d) per layer
        f = cfg.n_layers * (2 * e * (3 * d * d + d * d) + 2 * n * (2 * d * d + d * d))
        f += 2 * n * (d_feat * d + d * cfg.n_classes)
    return float(f)


def _gnn_batch_abstract(n: int, e: int, d_feat: int, with_dist: bool,
                        batched: int = 0) -> GraphBatch:
    return GraphBatch(
        x=_sds((n, d_feat), torch.float32),
        src=_sds((e,), torch.int32),
        dst=_sds((e,), torch.int32),
        edge_mask=_sds((e,), torch.bool),
        node_mask=_sds((n,), torch.bool),
        edge_attr=_sds((e, 1), torch.float32) if with_dist else None,
        graph_ids=_sds((n,), torch.int32) if batched else None,
    )


def _replicated_state(params_shape):
    p_specs = SH.replicated_like(params_shape)
    return TS.init_state(params_shape), TS.TrainState(
        p_specs, adamw.AdamWState(P(), p_specs, p_specs))


def _gnn_cell(cfg: registry.GNNConfig, shape, mesh) -> Cell:
    kind = shape["kind"]
    if kind == "sampled" and cfg.kind == "graphsage":
        return _sage_sampled_cell(cfg, shape, mesh)
    d_feat = shape["d_feat"]
    if kind == "sampled":
        # non-sampling archs: train on the sampler-induced padded subgraph
        bn = shape["batch_nodes"]
        f1, f2 = shape["fanout"]
        n = _pad_to(bn * (1 + f1 + f1 * f2), 512)
        e = _pad_to(bn * (f1 + f1 * f2), 512)
        batched = 0
    elif kind == "batched_small":
        bsz = shape["batch"]
        n = _pad_to(shape["n_nodes"] * bsz, 512)
        e = _pad_to(shape["n_edges"] * bsz, 512)
        batched = bsz
    else:
        n = _pad_to(shape["n_nodes"], 512)
        e = _pad_to(shape["n_edges"], 512)
        batched = 0

    with_dist = cfg.kind == "schnet"
    if cfg.kind == "schnet":
        batched = max(batched, 1)  # molecule readout needs graph_ids
    batch_abs = _gnn_batch_abstract(n, e, d_feat, with_dist, batched)
    state_shape, state_specs = _replicated_state(_gnn_params(cfg, d_feat))
    b_specs = gnn_batch_spec_tree(cfg, shape, mesh)

    if cfg.kind == "schnet":
        batch = {"graph": batch_abs, "targets": _sds((batched or 1,), torch.float32)}
        loss = TS.schnet_loss(batched or 1)
    elif cfg.kind == "graphcast":
        batch = {"graph": batch_abs, "targets": _sds((n, cfg.n_classes), torch.float32)}
        loss = TS.graphcast_loss()
    else:
        batch = {
            "graph": batch_abs,
            "labels": _sds((n,), torch.int32),
            "label_mask": _sds((n,), torch.bool),
        }
        loss = TS.gcn_loss(None) if cfg.kind == "gcn" else TS.sage_full_loss()

    step = TS.make_train_step(loss, adamw.wsd_schedule(100, 10_000, 1_000, 1e-3))
    meta = {
        "model_flops": 3.0 * _gnn_flops(cfg, n, e, d_feat),  # fwd+bwd ~ 3x fwd
        "n_nodes": n,
        "n_edges": e,
        "kind": f"train_{kind}",
    }
    return Cell(step, (state_shape, batch), (state_specs, b_specs),
                (state_specs, _METRICS_SPECS), meta)


def gnn_batch_spec_tree(cfg: registry.GNNConfig, shape, mesh):
    """The batch spec tree of ``cfg``'s train cell on ``shape``, as the
    reference's cells lay it out (``launch/cells.py:307-334``):
    ``sage_sampled_specs`` for GraphSAGE's sampled cell; else the graph
    by ``gnn_batch_specs`` (edges over the batch axes, nodes over
    ``model`` for the ``full_large`` cell), labels and label mask on the
    nodes' layout, GraphCast's targets on the node features' and SchNet's
    replicated.  ``edge_attr`` is SchNet's, ``graph_ids`` a batched
    cell's or SchNet's."""
    kind = shape["kind"]
    if kind == "sampled" and cfg.kind == "graphsage":
        return SH.sage_sampled_specs(mesh)
    with_dist = cfg.kind == "schnet"
    batched = kind == "batched_small" or cfg.kind == "schnet"
    shard_nodes = kind == "full_large"
    d = SH.gnn_batch_specs(mesh, shard_nodes=shard_nodes)
    g_specs = GraphBatch(
        x=d["x"], src=d["src"], dst=d["dst"], edge_mask=d["edge_mask"],
        node_mask=d["node_mask"], edge_attr=d["edge_attr"] if with_dist else None,
        graph_ids=d["graph_ids"] if batched else None,
    )
    if cfg.kind == "schnet":
        return {"graph": g_specs, "targets": P(None)}
    if cfg.kind == "graphcast":
        return {"graph": g_specs, "targets": d["x"]}
    lbl_p = P("model") if shard_nodes else P(None)
    return {"graph": g_specs, "labels": lbl_p, "label_mask": lbl_p}


def _sage_sampled_cell(cfg, shape, mesh) -> Cell:
    bn = shape["batch_nodes"]
    f1, f2 = shape["fanout"]
    d = shape["d_feat"]
    state_shape, state_specs = _replicated_state(_gnn_params(cfg, d))
    batch = {
        "x_self": _sds((bn, d), torch.float32),
        "neigh_feats": [_sds((bn, f1, d), torch.float32), _sds((bn, f1, f2, d), torch.float32)],
        "neigh_masks": [_sds((bn, f1), torch.bool), _sds((bn, f1, f2), torch.bool)],
        "labels": _sds((bn,), torch.int32),
    }
    b_specs = gnn_batch_spec_tree(cfg, shape, mesh)
    step = TS.make_train_step(TS.sage_sampled_loss(),
                              adamw.wsd_schedule(100, 10_000, 1_000, 1e-3))
    dh = cfg.d_hidden
    fwd = bn * (1 + f1 + f1 * f2) * 2 * d * dh * 2 + bn * 2 * dh * cfg.n_classes
    meta = {"model_flops": 3.0 * fwd, "kind": "train_sampled", "batch_nodes": bn}
    return Cell(step, (state_shape, batch), (state_specs, b_specs),
                (state_specs, _METRICS_SPECS), meta)


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------


def _dcn_cell(cfg: registry.DCNConfig, shape, mesh) -> Cell:
    from ..models.recsys import dcn_v2

    kind = shape["kind"]
    B = shape["batch"]
    n_cand = shape.get("n_candidates", 0)
    params_shape = dcn_v2.init(
        None, n_dense=cfg.n_dense, n_sparse=cfg.n_sparse, embed_dim=cfg.embed_dim,
        vocab_per_field=cfg.vocab_per_field, n_cross=cfg.n_cross,
        mlp_dims=cfg.mlp_dims, n_candidates=n_cand if kind == "retrieval" else 0,
        device=META,
    )
    p_specs = SH.dcn_param_specs(params_shape, mesh)
    b = SH.batch_axes(mesh)
    bspec = b if B % 512 == 0 or B % _mesh_size(mesh, b) == 0 else None
    dense = _sds((B, cfg.n_dense), torch.float32)
    sparse = _sds((B, cfg.n_sparse), torch.int32)
    d0 = cfg.n_dense + cfg.n_sparse * cfg.embed_dim
    # dense-path flops per example: cross (n_cross * d0^2) + MLP + embed
    mlp_f = 0
    dims = [d0] + list(cfg.mlp_dims)
    for a, bb in zip(dims[:-1], dims[1:]):
        mlp_f += 2 * a * bb
    per_ex = cfg.n_cross * 2 * d0 * d0 + mlp_f + 2 * (cfg.mlp_dims[-1] + d0)

    if kind == "train":
        state_shape = TS.init_state(params_shape)
        z = SH.zero1_specs(p_specs, params_shape, mesh)
        state_specs = TS.TrainState(p_specs, adamw.AdamWState(P(), z, z))
        batch = {"dense": dense, "sparse_ids": sparse, "labels": _sds((B,), torch.float32)}
        b_specs = {"dense": P(bspec, None), "sparse_ids": P(bspec, None), "labels": P(bspec)}
        step = TS.make_train_step(TS.dcn_loss(), adamw.wsd_schedule(100, 10_000, 1_000, 1e-3))
        meta = {"model_flops": 3.0 * per_ex * B, "batch": B, "kind": "train"}
        return Cell(step, (state_shape, batch), (state_specs, b_specs),
                    (state_specs, _METRICS_SPECS), meta)
    if kind == "serve":
        meta = {"model_flops": per_ex * B, "batch": B, "kind": "serve"}
        return Cell(dcn_v2.serve, (params_shape, dense, sparse),
                    (p_specs, P(bspec, None), P(bspec, None)), None, meta)
    # retrieval: 1 query x n_candidates
    meta = {
        "model_flops": per_ex * B + 2.0 * n_cand * cfg.mlp_dims[-1],
        "batch": B,
        "kind": "retrieval",
    }
    return Cell(partial(dcn_v2.retrieval, top_k=128), (params_shape, dense, sparse),
                (p_specs, P(None, None), P(None, None)), None, meta)


# ---------------------------------------------------------------------------
# aspen-stream cells (the paper's own configuration at scale)
# ---------------------------------------------------------------------------


def _decode_pool_step(deltas, anchors_at, head_mask):
    """Delta-decode the compressed pool as one segmented cumsum over the
    flat lane (the reference's jnp formulation of the sharded decode)."""
    c = torch.cumsum(deltas, 0)
    hm = head_mask.to(torch.int64)
    chunk_id = torch.cumsum(hm, 0) - hm
    base = c - deltas  # exclusive cumsum
    per_chunk_base = torch.full_like(deltas, -1).scatter_reduce(
        0, chunk_id, torch.where(head_mask, base, -1), "amax", include_self=True)
    return anchors_at[chunk_id] + (c - per_chunk_base[chunk_id])


def _bfs_round(g, source, aux):
    """``bfs_levels``' first round from ``source``, a device scalar that is
    never read back: the loop body, which is what the reference's cost
    count sees of its while loop."""
    from ..core.traversal.torch_backend import dense_expand

    hit = torch.arange(g.n, device=g.device) == source
    levels = torch.where(hit, 0, -1).to(torch.int32)
    frontier = dense_expand(g, hit, aux) & (levels < 0)
    return torch.where(frontier, 1, levels)


def _stream_cell(cfg: registry.StreamConfig, shape, mesh, variant: str = "baseline") -> Cell:
    from ..core import flat_ctree as fct
    from ..core import flat_graph as fg

    kind = shape["kind"]
    cap = shape["pool_edges"]
    n = shape["n_nodes"]
    all_axes = tuple(a for a in ("pod", "data", "model") if a in SH.axis_sizes(mesh))
    if kind == "update" and variant == "shardmap":
        return _stream_update_shardmap_cell(shape, mesh, all_axes)
    if kind == "update" and variant == "overlay":
        return _stream_update_overlay_cell(shape, mesh, all_axes)
    g_abs = fg.FlatGraph(
        offsets=_sds((n + 1,), torch.int32),
        keys=_sds((cap,), torch.int64),
        m=_sds((), torch.int32),
    )
    g_specs = fg.FlatGraph(offsets=P(None), keys=P(all_axes), m=P())
    if kind == "update":
        bcap = shape["batch_edges"]
        batch_abs = fct.FlatCTree(data=_sds((bcap,), torch.int64), n=_sds((), torch.int32))
        batch_specs = fct.FlatCTree(data=P(all_axes), n=P())
        meta = {
            "model_flops": 0.0,  # pure data movement: memory/collective-bound
            "pool_bytes": cap * 8,
            "batch_edges": bcap,
            "kind": "stream_update",
        }
        return Cell(partial(fg.insert_edges, out_cap=cap), (g_abs, batch_abs),
                    (g_specs, batch_specs), g_specs, meta)
    if kind == "query":
        from ..core.traversal.torch_backend import EngineAux

        # the query cell consumes the version-pinned EngineAux (the
        # stream's mirror cache builds it once per version)
        aux_abs = EngineAux(
            src_c=_sds((cap,), torch.int32),
            dst_c=_sds((cap,), torch.int32),
            evalid=_sds((cap,), torch.bool),
            degrees=_sds((n,), torch.int32),
            dst_sorted=_sds((cap,), torch.int32),
            src_by_dst=_sds((cap,), torch.int32),
            valid_by_dst=_sds((cap,), torch.bool),
            dst_offsets=_sds((n + 1,), torch.int32),
        )
        lane = P(all_axes)
        aux_specs = EngineAux(
            src_c=lane, dst_c=lane, evalid=lane, degrees=P(None), dst_sorted=lane,
            src_by_dst=lane, valid_by_dst=lane, dst_offsets=P(None),
        )
        meta = {"model_flops": 0.0, "pool_bytes": cap * 8, "kind": "stream_bfs"}
        return Cell(_bfs_round, (g_abs, _sds((), torch.int32), aux_abs),
                    (g_specs, P(), aux_specs), None, meta)
    lane = P(all_axes)
    meta = {"model_flops": 0.0, "pool_bytes": cap * 8, "kind": "stream_decode"}
    return Cell(_decode_pool_step,
                (_sds((cap,), torch.int64), _sds((cap,), torch.int64), _sds((cap,), torch.bool)),
                (lane, lane, lane), None, meta)


def _stream_update_shardmap_cell(shape, mesh, all_axes) -> Cell:
    """The range-sharded pool, shard-local merge (``core/sharded_pool``):
    every rank merges the replicated batch into its own block of rows."""
    from ..core import sharded_pool as sp

    cap = shape["pool_edges"]
    bcap = shape["batch_edges"]
    n_shards = _mesh_size(mesh, all_axes)
    cap_per = 2 * cap // n_shards
    pool_abs = sp.ShardedPool(
        data=_sds((n_shards, cap_per), torch.int64),
        n=_sds((n_shards,), torch.int32),
        lo=_sds((n_shards,), torch.int64),
    )
    pool_specs = sp.ShardedPool(data=P(all_axes, None), n=P(all_axes), lo=P(all_axes))
    step = sp.make_insert_step(sp.PoolMesh(META, 1))
    meta = {"model_flops": 0.0, "pool_bytes": cap * 8, "batch_edges": bcap,
            "kind": "stream_update", "variant": "shardmap"}
    return Cell(step, (pool_abs, _sds((bcap,), torch.int64)), (pool_specs, P(None)),
                pool_specs, meta)


def _stream_update_overlay_cell(shape, mesh, all_axes) -> Cell:
    """LSM-style overlay: updates merge into a small overlay pool
    (compacted into the base pool asynchronously); per-step traffic is
    O(overlay + batch), not O(pool)."""
    from ..core import flat_ctree as fct

    bcap = shape["batch_edges"]
    overlay_cap = 8 * bcap  # overlay compacted every ~8 batches
    o_abs = fct.FlatCTree(data=_sds((overlay_cap,), torch.int64), n=_sds((), torch.int32))
    b_abs = fct.FlatCTree(data=_sds((bcap,), torch.int64), n=_sds((), torch.int32))
    o_specs = fct.FlatCTree(data=P(all_axes), n=P())
    b_specs = fct.FlatCTree(data=P(all_axes), n=P())
    meta = {"model_flops": 0.0, "pool_bytes": shape["pool_edges"] * 8,
            "batch_edges": bcap, "kind": "stream_update", "variant": "overlay"}
    return Cell(partial(fct.union_merge, out_cap=overlay_cap), (o_abs, b_abs),
                (o_specs, b_specs), o_specs, meta)


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------


def build_cell(arch_id: str, shape_name: str, mesh, reduced: bool = False,
               n_layers_override: Optional[int] = None,
               overrides: Optional[Dict[str, Any]] = None,
               variant: str = "baseline") -> Cell:
    """The cell of ``arch_id`` at ``shape_name`` laid out on ``mesh`` (a
    ``DeviceMesh`` or any object with an axis-name -> size ``shape``).
    ``overrides`` replace LM config fields; ``moe_shard_dispatch`` and
    ``moe_dispatch_shards`` reach the MoE fields, and
    ``moe_impl="shardmap"`` sets ``models.moe_shardmap.ACTIVE_MESH`` to
    ``mesh``, as the reference's cells do."""
    spec = registry.get(arch_id)
    cfg = spec.reduced if reduced else spec.full
    if n_layers_override is not None and spec.family == "lm":
        cfg = dataclasses.replace(cfg, n_layers=n_layers_override)
    if overrides and spec.family == "lm":
        overrides = dict(overrides)
        if "moe_shard_dispatch" in overrides:
            flag = overrides.pop("moe_shard_dispatch")
            if cfg.moe is not None:
                cfg = dataclasses.replace(
                    cfg, moe=dataclasses.replace(cfg.moe, shard_dispatch=flag)
                )
        if "moe_dispatch_shards" in overrides:
            ns = overrides.pop("moe_dispatch_shards")
            if cfg.moe is not None:
                cfg = dataclasses.replace(
                    cfg, moe=dataclasses.replace(cfg.moe, dispatch_shards=ns)
                )
        if overrides.pop("moe_impl", None) == "shardmap":
            from ..models import moe_shardmap as MS

            MS.ACTIVE_MESH = mesh
            cfg = dataclasses.replace(cfg, moe_impl="shardmap")
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
    shape = spec.shapes[shape_name]
    if spec.family == "lm":
        kind = shape["kind"]
        if kind == "train":
            return _lm_train_cell(cfg, shape, mesh)
        if kind == "prefill":
            return _lm_prefill_cell(cfg, shape, mesh)
        return _lm_decode_cell(cfg, shape, mesh)
    if spec.family == "gnn":
        return _gnn_cell(cfg, shape, mesh)
    if spec.family == "recsys":
        return _dcn_cell(cfg, shape, mesh)
    if spec.family == "stream":
        return _stream_cell(cfg, shape, mesh, variant=variant)
    raise ValueError(spec.family)
