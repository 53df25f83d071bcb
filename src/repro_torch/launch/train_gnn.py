"""End-to-end trainer: GraphSAGE on a streaming graph.

    PYTHONPATH=src python -m repro_torch.launch.train_gnn [--steps 300] [--device cpu]

Counterpart of ``examples/train_gnn.py``, with its flags and defaults
plus ``--device`` (default the card, ``cuda``) and ``--ckpt-every``.
The stack working together:
  * an Aspen flat graph as the storage layer: a power-law graph built
    with ``flat_graph.from_edges``, 512 random edges inserted every
    ``--stream-every`` steps through ``insert_edges_host``;
  * the device ``NeighborSampler`` reading the live snapshot's CSR pool;
  * ``graphsage`` trained with AdamW and the WSD schedule
    (``make_train_step(sage_sampled_loss(), wsd_schedule(20, steps, 50,
    1e-2))``), the fanout aggregation in torch (``use_kernel=False``, as
    the reference's training and evaluation run it);
  * checkpoint and restore through ``ResumableRun`` (every
    ``--ckpt-every`` steps, 100 as in the reference).

The features, labels, inserted edges and batches are the reference's
numpy draws: ``default_rng(0)`` for the features, labels and inserted
edges, and each batch a pure function of (0, step).  Two departures:
  * the reference re-reads the CSR arrays and builds a sampler on every
    step; the port builds one when the snapshot changes (on the card a
    re-read would copy the whole edge lane each step), and the batches
    stay the reference's, bit for bit;
  * a checkpoint is named by the steps its state took (the port's
    convention, ``launch/train.py``), so a resumed run takes the next
    batch; it replays the inserts of the steps before it from the same
    generator, so it trains on the uninterrupted run's graph.  The
    reference resumes at the saved step's batch again, on the graph
    before any insert.
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.core import flat_graph as fg
from repro_torch.data.pipeline import NeighborSampler, power_law_graph
from repro_torch.dist.fault_tolerance import ResumableRun
from repro_torch.models.gnn import graphsage
from repro_torch.optim import adamw
from repro_torch.train import train_step as TS

STREAM_EDGES = 512  # edges inserted per streaming step


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--m", type=int, default=120_000)
    ap.add_argument("--d-feat", type=int, default=64)
    ap.add_argument("--d-hidden", type=int, default=128)
    ap.add_argument("--classes", type=int, default=16)
    ap.add_argument("--fanout", type=int, nargs=2, default=(15, 10))
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_train_gnn"))
    ap.add_argument("--stream-every", type=int, default=50,
                    help="insert a batch of new edges every K steps")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


class StreamingGraph:
    """The flat graph, its streaming inserts and the sampler over its
    live snapshot; ``sampler`` is rebuilt only when an insert lands."""

    def __init__(self, graph: fg.FlatGraph, feats: torch.Tensor, rng: np.random.Generator,
                 n: int, stream_every: int):
        self.graph, self.feats, self.rng = graph, feats, rng
        self.n, self.stream_every = n, stream_every
        self.rebuilds = 0
        self._sampler: Optional[NeighborSampler] = None

    def advance(self, step: int) -> None:
        """Insert the step's new edges, when one falls due (the live
        streaming insert: the sampler then reads the new snapshot)."""
        if step % self.stream_every == 0 and step > 0:
            new = np.stack([self.rng.integers(0, self.n, STREAM_EDGES),
                            self.rng.integers(0, self.n, STREAM_EDGES)], 1)
            self.graph = fg.insert_edges_host(self.graph, new)
            self._sampler = None

    @property
    def sampler(self) -> NeighborSampler:
        if self._sampler is None:
            g = self.graph
            self._sampler = NeighborSampler(g.offsets, g.keys[: int(g.m)] & 0xFFFFFFFF,
                                            self.feats)
            self.rebuilds += 1
        return self._sampler


def make_stream(args, device=None) -> tuple:
    """(StreamingGraph, labels on the device): the reference's graph,
    features and labels, drawn in its order."""
    dev = resolve(device)
    offsets, nbrs = power_law_graph(args.n, args.m, seed=0)
    edges = np.stack([np.repeat(np.arange(args.n), np.diff(offsets)), nbrs], 1)
    graph = fg.from_edges(args.n, edges, device=dev)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((args.n, args.d_feat)).astype(np.float32)
    # labels correlated with features so training learns something real
    w_true = rng.standard_normal((args.d_feat, args.classes))
    labels = (feats @ w_true).argmax(1)
    stream = StreamingGraph(graph, torch.from_numpy(feats).to(dev), rng, args.n,
                            args.stream_every)
    return stream, torch.from_numpy(labels).to(dev)


def batch_of(sampler: NeighborSampler, labels: torch.Tensor, step: int, args) -> Dict:
    sb = sampler.sample_batch(0, step, args.batch, tuple(args.fanout))
    return {
        "x_self": sb["x_self"],
        "neigh_feats": sb["neigh_feats"],
        "neigh_masks": sb["neigh_masks"],
        "labels": labels[sb["seeds"]],
    }


def eval_acc(params, sampler: NeighborSampler, labels: torch.Tensor, args) -> float:
    sb = sampler.sample_batch(1, 999, 512, tuple(args.fanout))
    with torch.no_grad():
        logits = graphsage.forward_sampled(params, sb["x_self"], sb["neigh_feats"],
                                           sb["neigh_masks"])
    return float((logits.argmax(1) == labels[sb["seeds"]]).float().mean())


def train(args, params=None, log: Callable[[str], None] = print,
          stop_after: Optional[int] = None, data=None) -> Dict:
    """Runs the trainer.  ``params`` replaces the seeded init (the tests
    carry the reference's parameters in); ``stop_after`` ends the loop
    after that step, as a killed run would; ``data``, a fresh
    ``(StreamingGraph, labels)``, replaces ``make_stream(args)`` (a graph
    already on the card).  Returns ``{"state", "history", "acc", "start",
    "stream"}``; ``history`` holds per step its index, loss, gnorm, lr and
    host seconds."""
    dev = resolve(args.device)
    stream, labels = make_stream(args, dev) if data is None else data
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(0)
        params = graphsage.init(gen, args.d_feat, args.d_hidden, args.classes, device=dev)
    step_fn = TS.make_train_step(
        TS.sage_sampled_loss(), adamw.wsd_schedule(20, args.steps, 50, 1e-2)
    )
    run = ResumableRun(args.ckpt_dir, make_state=lambda: TS.init_state(params),
                       save_every=args.ckpt_every, device=dev)
    start, state = run.restore_or_init()
    if start:
        log(f"[restore] resuming from step {start}")
    for step in range(start):  # the inserts the checkpointed run made
        stream.advance(step)

    history: List[dict] = []
    end = args.steps if stop_after is None else min(args.steps, stop_after + 1)
    t0 = time.time()
    for step in range(start, end):
        t = time.time()
        stream.advance(step)
        state, metrics = step_fn(state, batch_of(stream.sampler, labels, step, args))
        history.append({"step": step, **{k: float(v) for k, v in metrics.items()},
                        "s": time.time() - t})
        run.maybe_save(step + 1, state)
        if step % 25 == 0:
            acc = eval_acc(state.params, stream.sampler, labels, args)
            log(f"step {step:4d}  loss {history[-1]['loss']:.4f}  "
                f"acc {acc:.3f}  edges {int(stream.graph.m)}  "
                f"({(time.time() - t0) / max(step - start + 1, 1):.3f} s/step)")
    run.finish()
    acc = eval_acc(state.params, stream.sampler, labels, args)
    log(f"done. final accuracy {acc:.3f} (chance {1 / args.classes:.3f})")
    return {"state": state, "history": history, "acc": acc, "start": start, "stream": stream}


def main(argv=None):
    return train(parser().parse_args(argv))


if __name__ == "__main__":
    main()
