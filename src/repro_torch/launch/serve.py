"""Serving launcher: batched generation with a KV cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b --reduced \\
        --batch 4 --prompt-len 16 --max-new 32

Counterpart of ``repro/launch/serve.py``: random float32 weights from
``--seed``, a random prompt, ``generate`` without the flash kernel, as
the reference calls it.  ``--device`` defaults to the card (``cuda``);
``--device cpu`` runs on the host.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.configs import registry
from repro_torch.models import transformer as T
from repro_torch.serve.decode import generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=registry.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    spec = registry.get(args.arch)
    if spec.family != "lm":
        ap.error("the serving launcher is for the LM family")
    cfg = spec.reduced if args.reduced else spec.full
    dev = resolve(args.device)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = T.init_params(gen, cfg, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(args.seed)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (args.batch, args.prompt_len))).to(dev)
    key = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.time()
    out = generate(params, cfg, prompt, args.max_new, temperature=args.temperature, key=key)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    n_tok = args.batch * args.max_new
    print(f"generated {tuple(out.shape)} in {dt:.2f}s  ({n_tok / dt:.1f} tok/s)")
    print("sample:", out[0, args.prompt_len:].tolist()[:16])


if __name__ == "__main__":
    main()
