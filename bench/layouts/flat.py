"""The raw layout: a ``FlatGraph`` pool of packed keys, served by ``TorchEngine``.

The publish is what ``AspenStream`` does to its flat mirror, without the
host tree (``_mirror_insert``, ``_mirror_delete``): the program's own
``AspenStream._device_batch`` packs the handed-over (k, 2) edges on the
host at a power-of-two shape, ships them and sorts and deduplicates them
on the device (``flat_ctree.from_device``); then the batch is
rank-merged into the pool or its keys dropped from it, with the output
capacity and vertex count from host-tracked counts.  Each publish makes
a new version; the old one is left as it was.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.core import flat_ctree as fct
from repro_torch.core import flat_graph as fg
from repro_torch.core import traversal
from repro_torch.core.streaming import AspenStream


def build(cfg: dict, keys: np.ndarray, device):
    """The first version, from the initial graph's sorted keys on the host."""
    edges = np.stack([keys >> 32, keys & 0xFFFFFFFF], axis=1)
    return fg.from_edges(cfg["n"], edges, edge_capacity=cfg["pool_edges"], device=device)


def device_batch(edges: np.ndarray, device, span) -> fct.FlatCTree:
    """The program's packing, upload and device sort of a batch
    (``_device_batch`` reads nothing of its stream but the device)."""
    with span("publish.batch"):
        return AspenStream._device_batch(SimpleNamespace(device=torch.device(device)), edges)


def out_capacity(v, m: int, edges: np.ndarray) -> int:
    return max(v.edge_capacity, fct.grown_capacity(m + edges.shape[0]))


def n_out(v, edges: np.ndarray):
    """The grown vertex count when the batch names new sources, else None."""
    n = max(v.n, int(edges[:, 0].max()) + 1)
    return None if n == v.n else n


def publish(v, kind: str, edges: np.ndarray, m: int, device, span):
    """A new version with the batch ``edges`` inserted or deleted; ``m``
    is the writer's host count of ``v``'s edges."""
    batch = device_batch(edges, device, span)
    with span("publish.merge"):
        if kind == "insert":
            return fg.insert_edges_device(v, batch, out_capacity(v, m, edges),
                                          n_out=n_out(v, edges))
        return fg.delete_edges_device(v, batch)


def wait(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def settle(v):
    """Wait until the version is complete on the device: (m, spilled)."""
    wait(v.device)
    return int(v.m), False


def engine(v):
    return traversal.make_engine(v)


def storages(v) -> list:
    """The version's own device storages."""
    return [t for t in v if torch.is_tensor(t)]


def judged(v) -> dict:
    """What the reference judges of a version."""
    return {"keys": v.keys, "offsets": v.offsets, "m": int(v.m)}
