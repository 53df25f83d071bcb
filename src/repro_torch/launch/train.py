"""Training launcher: end-to-end driver over the LM and recsys archs.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --reduced --steps 200 --batch 8 --seq 128 --ckpt-dir build/run1

Counterpart of ``repro/launch/train.py``, with its flags plus
``--device`` (default the card, ``cuda``; ``--device cpu`` runs on the
host).  Parameters are float32 draws from ``--seed`` on the device;
batches are the reference's numpy draws (``data.pipeline``), a pure
function of (seed, step); the step is ``train.train_step.make_train_step``
with the WSD schedule.  With ``--ckpt-dir`` the run restores and resumes
through ``dist.fault_tolerance.ResumableRun``.

One departure: a checkpoint is named by the number of steps its state
has taken (its ``opt.step``), so a run resumed from checkpoint k starts
at batch k and reproduces the uninterrupted run.  The reference saves
the state after batch k under k and resumes at batch k, which takes
batch k a second time.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional

import torch

from repro_torch._device import resolve
from repro_torch.configs import registry
from repro_torch.data.pipeline import recsys_batch, token_batch
from repro_torch.dist.fault_tolerance import ResumableRun
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import train_step as TS


def _on(dev: torch.device, batch: dict) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def make_lm_run(cfg, args):
    dev = resolve(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(gen, cfg, dtype=torch.float32, device=dev)
    step_fn = TS.make_train_step(
        TS.lm_loss(cfg),
        adamw.wsd_schedule(args.warmup, args.steps, max(args.steps // 10, 1), args.lr),
        n_micro=args.n_micro,
    )

    def batch_fn(step):
        return _on(dev, token_batch(args.seed, step, args.batch, args.seq, cfg.vocab))

    return params, step_fn, batch_fn


def make_dcn_run(cfg, args):
    from repro_torch.models.recsys import dcn_v2

    dev = resolve(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = dcn_v2.init(
        gen, n_dense=cfg.n_dense, n_sparse=cfg.n_sparse,
        embed_dim=cfg.embed_dim, vocab_per_field=cfg.vocab_per_field,
        n_cross=cfg.n_cross, mlp_dims=cfg.mlp_dims, device=dev,
    )
    step_fn = TS.make_train_step(
        TS.dcn_loss(), adamw.wsd_schedule(args.warmup, args.steps, 10, args.lr)
    )

    def batch_fn(step):
        return _on(dev, recsys_batch(args.seed, step, args.batch, cfg.n_dense, cfg.n_sparse,
                                     cfg.vocab_per_field))

    return params, step_fn, batch_fn


def train_loop(step_fn, batch_fn, state, start_step: int, steps: int,
               run: Optional[ResumableRun] = None, log_every: int = 10,
               log: Callable[[str], None] = print):
    """Steps ``start_step .. steps - 1`` from ``state``; after each, the
    run's checkpoint when it falls due (named by the steps taken).
    Returns (state, history), history holding per step its index and
    float loss, gnorm and lr."""
    history: List[dict] = []
    t0 = time.time()
    for step in range(start_step, steps):
        state, metrics = step_fn(state, batch_fn(step))
        history.append({"step": step, **{k: float(v) for k, v in metrics.items()}})
        if step % log_every == 0:
            h = history[-1]
            log(
                f"step {step:5d} loss {h['loss']:.4f} "
                f"gnorm {h['grad_norm']:.3f} lr {h['lr']:.2e} "
                f"({(time.time() - t0) / max(step - start_step + 1, 1):.3f} s/step)"
            )
        if run is not None:
            run.maybe_save(step + 1, state)
    return state, history


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv=None):
    """Runs the CLI; returns the history of the steps it took."""
    args = parser().parse_args(argv)

    spec = registry.get(args.arch)
    cfg = spec.reduced if args.reduced else spec.full
    if spec.family == "lm":
        params, step_fn, batch_fn = make_lm_run(cfg, args)
    elif spec.family == "recsys":
        params, step_fn, batch_fn = make_dcn_run(cfg, args)
    else:
        raise SystemExit(
            f"--arch {args.arch}: use python -m repro_torch.launch.train_gnn for the GNN "
            "family (the port of examples/train_gnn.py)"
        )

    start_step = 0
    state = TS.init_state(params)
    run = None
    if args.ckpt_dir:
        run = ResumableRun(
            args.ckpt_dir, make_state=lambda: TS.init_state(params),
            save_every=args.ckpt_every, device=args.device,
        )
        start_step, state = run.restore_or_init()
        if start_step:
            print(f"[restore] resumed from step {start_step}")

    t0 = time.time()
    state, history = train_loop(step_fn, batch_fn, state, start_step, args.steps, run,
                                args.log_every)
    if run is not None:
        run.finish()
    final = f"; final loss {history[-1]['loss']:.4f}" if history else ""
    print(f"done: {args.steps - start_step} steps in {time.time() - t0:.1f}s{final}")
    return history


if __name__ == "__main__":
    main()
