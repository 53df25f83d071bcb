"""Data pipelines: the token and recsys batch makers, the neighbour
sampler and the power-law stand-in graph.

Counterpart of ``repro/data/pipeline.py:17-39`` and ``:71-123``
(``molecule_batch`` comes with SchNet, ROADMAP item 14).  Every batch is
a pure function of (seed, step) — the fault-tolerance contract: after a
restore at step k the pipeline re-produces exactly the batch it would
have produced, with no stateful iterator to checkpoint.  The batch
makers return the reference's numpy draws, bit for bit; the trainer
moves them to its device.

The sampler reads a CSR held on the device — exactly the Aspen flat
graph pool's layout (``offsets``, and ``keys & 0xFFFFFFFF`` as the
neighbour array), so the streaming store is sampled in place — and
gathers features from a device-resident table.  The random draws stay
the reference's numpy draws from ``default_rng(seed * 104729 + step)``,
so sampled ids and masks are bit-identical to the reference's; that
costs two small device-to-host copies of degrees per batch (B values,
then B * f1).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def token_batch(seed: int, step: int, batch: int, seq_len: int, vocab: int,
                host_id: int = 0, n_hosts: int = 1) -> Dict[str, np.ndarray]:
    """Synthetic LM batch (a markov-ish stream, so the loss is learnable):
    int64 ``tokens`` and ``labels`` (batch // n_hosts, seq_len).  Each
    host draws its own slice — the multi-host sharding contract."""
    rng = np.random.default_rng((seed * 1_000_003 + step) * 64 + host_id)
    shard = batch // n_hosts
    base = rng.integers(0, vocab, size=(shard, seq_len + 1), dtype=np.int64)
    # inject local structure: next token correlated with current
    corr = (base[:, :-1] * 31 + 7) % vocab
    take = rng.random((shard, seq_len)) < 0.5
    base[:, 1:][take] = corr[take]
    return {"tokens": base[:, :-1], "labels": base[:, 1:]}


def recsys_batch(seed: int, step: int, batch: int, n_dense: int = 13,
                 n_sparse: int = 26, vocab: int = 100_000) -> Dict[str, np.ndarray]:
    """Synthetic CTR batch: float32 ``dense`` (batch, n_dense), int64
    ``sparse_ids`` (batch, n_sparse) below ``vocab``, float32 ``labels``
    (a quarter positive)."""
    rng = np.random.default_rng((seed * 999_983 + step))
    return {
        "dense": rng.standard_normal((batch, n_dense)).astype(np.float32),
        "sparse_ids": rng.integers(0, vocab, size=(batch, n_sparse)),
        "labels": (rng.random(batch) < 0.25).astype(np.float32),
    }


class NeighborSampler:
    """Uniform fixed-fanout 2-hop sampling over a CSR graph on the device.

    ``offsets`` (n+1,) and ``nbrs`` (m,) integer tensors and ``feats``
    (n, d) on one device.  Deterministic per (seed, step).
    """

    def __init__(self, offsets: torch.Tensor, nbrs: torch.Tensor, feats: torch.Tensor):
        if len({offsets.device, nbrs.device, feats.device}) != 1:
            raise ValueError("offsets, nbrs and feats must lie on one device")
        self.offsets = offsets.to(torch.int64)
        self.nbrs = nbrs
        self.feats = feats
        self.n = self.offsets.shape[0] - 1

    def _sample_neighbors(self, rng: np.random.Generator, nodes: torch.Tensor, fanout: int):
        """(len(nodes), fanout) int64 neighbour ids and bool mask on the
        device; the picks are drawn on the host from the nodes' degrees."""
        start = self.offsets[nodes]
        deg = self.offsets[nodes + 1] - start
        deg_host = deg.cpu().numpy()
        picks = rng.integers(0, np.maximum(deg_host, 1)[:, None], size=(nodes.numel(), fanout))
        idx = start[:, None] + torch.from_numpy(picks).to(nodes.device)
        out = self.nbrs[torch.clamp(idx, max=self.nbrs.numel() - 1)]
        mask = (deg > 0)[:, None].expand(-1, fanout)
        return torch.where(mask, out, 0).to(torch.int64), mask

    def sample_ids(self, seed: int, step: int, batch_nodes: int, fanouts) -> Dict:
        """The draw: ``seeds`` (B,), ``ids`` [(B, f1), (B, f1, f2)] and
        ``neigh_masks`` [(B, f1), (B, f1, f2)], on the device."""
        rng = np.random.default_rng(seed * 104_729 + step)
        seeds = torch.from_numpy(rng.integers(0, self.n, size=batch_nodes)).to(self.feats.device)
        f1, f2 = fanouts
        n1, m1 = self._sample_neighbors(rng, seeds, f1)
        n2_flat, m2_flat = self._sample_neighbors(rng, n1.reshape(-1), f2)
        n2 = n2_flat.reshape(batch_nodes, f1, f2)
        m2 = m2_flat.reshape(batch_nodes, f1, f2) & m1[:, :, None]
        return {"seeds": seeds, "ids": [n1, n2], "neigh_masks": [m1, m2]}

    def gather(self, sample: Dict) -> Dict:
        """GraphSAGE tensors of a draw: x_self (B, d), neigh_feats
        [(B, f1, d), (B, f1, f2, d)], neigh_masks, seeds."""
        return {
            "x_self": self.feats[sample["seeds"]],
            "neigh_feats": [self.feats[ids] for ids in sample["ids"]],
            "neigh_masks": sample["neigh_masks"],
            "seeds": sample["seeds"],
        }

    def sample_batch(self, seed: int, step: int, batch_nodes: int, fanouts) -> Dict:
        """``gather(sample_ids(...))``: the reference's batch, on the device."""
        return self.gather(self.sample_ids(seed, step, batch_nodes, fanouts))


def power_law_graph(n: int, m: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Host CSR power-law graph (reddit/products stand-in) via rMAT:
    ``m`` draws over the next power of two, symmetrized, ids >= n dropped."""
    from .rmat import rmat_edges, symmetrize

    log_n = int(np.ceil(np.log2(n)))
    e = symmetrize(rmat_edges(log_n, m, seed=seed))
    e = e[(e[:, 0] < n) & (e[:, 1] < n)]
    keys = np.unique((e[:, 0] << 32) | e[:, 1])
    srcs, nbrs = keys >> 32, keys & 0xFFFFFFFF
    offsets = np.searchsorted(srcs, np.arange(n + 1))
    return offsets, nbrs.astype(np.int64)
