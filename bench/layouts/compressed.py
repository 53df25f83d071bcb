"""The compressed layout: a ``CompressedPool`` (the dst lane chunk-encoded
with adaptive widths and spare hi rows), served by ``CompressedEngine``.

The layout of ``AspenStream(compressed=True)``'s mirror: the raw pool
built and then compressed by ``flat_graph.compress_host`` with
``hi_headroom``.  A publish packs and ships the batch as the raw layout
does (the program's ``_device_batch``), then
decompresses, rank-merges (or drops) and recompresses the whole pool
(``insert_edges_compressed`` / ``delete_edges_compressed``).  A publish
whose new version reports a spill (an escape lane or the hi plane
overflowed) is a failed publish: its version does not decode.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import flat_graph as fg
from repro_torch.core import traversal

from . import flat


def build(cfg: dict, keys: np.ndarray, device):
    return fg.compress_host(flat.build(cfg, keys, device), hi_headroom=cfg["hi_headroom"])


def publish(v, kind: str, edges: np.ndarray, m: int, device, span):
    batch = flat.device_batch(edges, device, span)
    with span("publish.merge"):
        if kind == "insert":
            return fg.insert_edges_compressed(v, batch, flat.out_capacity(v, m, edges),
                                              flat.n_out(v, edges))
        return fg.delete_edges_compressed(v, batch, v.edge_capacity)


def settle(v):
    flat.wait(v.device)
    m, spill = torch.stack([v.m.to(torch.int64), v.dst.spill.to(torch.int64)]).tolist()
    return m, bool(spill)


def engine(v):
    return traversal.make_engine(v)


def storages(v) -> list:
    s = v.dst
    leaves = [v.offsets, v.m, v.weights, s.anchors, s.deltas, s.ovf_pos, s.ovf_add, s.spill,
              s.hi, s.wide]
    return [t for t in leaves if torch.is_tensor(t)]


def judged(v) -> dict:
    s = v.dst
    return {"stream": (s.anchors, s.deltas, s.ovf_pos, s.ovf_add, s.hi, s.wide),
            "offsets": v.offsets, "m": int(v.m), "spill": bool(s.spill)}
