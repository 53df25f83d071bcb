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

Across ranks the same script trains data-parallel with ZeRO-1, as the
reference's "runs under multi-host jax.distributed initialization": under
``torchrun --nproc-per-node k`` (``WORLD_SIZE`` above 1; or with a
process group of more than one rank already up) it calls
``launch.mesh.init_ranks``, lays a ``(k, 1)`` ("data", "model") mesh over
the ranks, and trains on it (``train_step.make_train_step(mesh=)``):
``--batch`` is the global batch, each rank takes its 1/k, and
``--n-micro`` slices of the global batch become ``n_micro / k`` slices of
each rank's part (``--n-micro`` must be 1 or a multiple of k), so a run
on k ranks takes the one-rank run's steps; at ``--n-micro 1`` each rank
takes its part whole, which is the one-rank run at ``--n-micro k``.
Checkpoints are saved and restored with the state's specs; only rank 0
logs.
"""
from __future__ import annotations

import argparse
import os
import time
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from repro_torch._device import resolve
from repro_torch.configs import registry
from repro_torch.data.pipeline import recsys_batch, token_batch
from repro_torch.dist.fault_tolerance import ResumableRun
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.train import train_step as TS


def _on(dev: torch.device, batch: dict) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def data_mesh(device=None):
    """The ``(k, 1)`` ("data", "model") mesh of a multi-rank run (torchrun's
    ``WORLD_SIZE`` above 1, or a process group of more than one rank
    already up), else None."""
    from repro_torch.launch import mesh as mesh_lib

    up = dist.is_initialized() and dist.get_world_size() > 1
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 and not up:
        return None
    # a group already up is kept, whatever its backend (gloo ranks may
    # share a card)
    dev = resolve(device) if dist.is_initialized() else mesh_lib.init_ranks(device=device)
    return mesh_lib.rank_mesh((dist.get_world_size(), 1), ("data", "model"), device=dev.type)


def train_specs(family: str, cfg, params, mesh):
    """The ``TrainState`` spec tree on ``mesh``: the family's parameter
    specs and their ZeRO-1 moments, as the reference's cells lay them out
    (``launch/cells.py:76-79`` for the LMs, ``:383`` for DCN-v2), and the
    GNN family's replicated state, parameters and moments on ``P()`` with
    no ZeRO-1 (``:302-305``)."""
    from repro_torch.dist import shardings as SH
    from repro_torch.launch import cells

    if family == "lm":
        return cells._lm_state_specs(cfg, mesh, params)
    if family == "gnn":
        p_specs = SH.replicated_like(params)
        return TS.TrainState(p_specs, adamw.AdamWState(SH.P(), p_specs, p_specs))
    p_specs = SH.dcn_param_specs(params, mesh)
    z = SH.zero1_specs(p_specs, params, mesh)
    return TS.TrainState(p_specs, adamw.AdamWState(SH.P(), z, z))


def _n_micro(args, mesh) -> int:
    """Slices of each rank's part: ``--n-micro`` of the global batch over
    the mesh's k ranks.  ``--n-micro`` must be 1 or a multiple of k; at 1
    each rank takes its part whole, which is the one-rank step at
    ``--n-micro k``, not at 1 (the gradients then add in another order)."""
    if mesh is None:
        return args.n_micro
    # the data ranks of a ("data", "model") mesh
    k = mesh.size() if getattr(mesh, "mesh_dim_names", None) is None else mesh.size(0)
    if args.n_micro > 1 and args.n_micro % k:
        raise SystemExit(f"--n-micro {args.n_micro} does not split over {k} ranks: "
                         f"give 1 or a multiple of {k}")
    return max(1, args.n_micro // k)


def make_lm_run(cfg, args, mesh=None):
    dev = resolve(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(gen, cfg, dtype=torch.float32, device=dev)
    step_fn = TS.make_train_step(
        TS.lm_loss(cfg),
        adamw.wsd_schedule(args.warmup, args.steps, max(args.steps // 10, 1), args.lr),
        n_micro=_n_micro(args, mesh), mesh=mesh,
        specs=None if mesh is None else train_specs("lm", cfg, params, mesh),
    )

    def batch_fn(step):
        return _on(dev, token_batch(args.seed, step, args.batch, args.seq, cfg.vocab))

    return params, step_fn, batch_fn


def make_dcn_run(cfg, args, mesh=None):
    from repro_torch.models.recsys import dcn_v2

    dev = resolve(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = dcn_v2.init(
        gen, n_dense=cfg.n_dense, n_sparse=cfg.n_sparse,
        embed_dim=cfg.embed_dim, vocab_per_field=cfg.vocab_per_field,
        n_cross=cfg.n_cross, mlp_dims=cfg.mlp_dims, device=dev,
    )
    step_fn = TS.make_train_step(
        TS.dcn_loss(), adamw.wsd_schedule(args.warmup, args.steps, 10, args.lr),
        n_micro=_n_micro(args, mesh), mesh=mesh,
        specs=None if mesh is None else train_specs("recsys", cfg, params, mesh),
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
    if spec.family not in ("lm", "recsys"):
        raise SystemExit(
            f"--arch {args.arch}: use python -m repro_torch.launch.train_gnn for the GNN "
            "family (the port of examples/train_gnn.py)"
        )
    mesh = data_mesh(args.device)
    make = make_lm_run if spec.family == "lm" else make_dcn_run
    params, step_fn, batch_fn = make(cfg, args, mesh)
    log = print if mesh is None or dist.get_rank() == 0 else (lambda *a, **k: None)
    specs = None if mesh is None else train_specs(spec.family, cfg, params, mesh)

    run = ResumableRun(
        args.ckpt_dir, make_state=lambda: TS.init_state(params),
        save_every=args.ckpt_every, device=args.device, specs=specs, mesh=mesh,
    )
    start_step, state = run.restore_or_init()
    if start_step:
        log(f"[restore] resumed from step {start_step}")

    t0 = time.time()
    state, history = train_loop(step_fn, batch_fn, state, start_step, args.steps,
                                run if args.ckpt_dir else None, args.log_every, log)
    run.finish()
    final = f"; final loss {history[-1]['loss']:.4f}" if history else ""
    log(f"done: {args.steps - start_step} steps in {time.time() - t0:.1f}s{final}")
    return history


if __name__ == "__main__":
    main()
