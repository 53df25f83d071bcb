"""Bytes autograd keeps for the backward of one blockwise attention call.

    PYTHONPATH=src python scripts/attention_saved_bytes.py [--src DIR] [--shape B S H Kv d]

Runs ``models.layers._blockwise_attention`` of the port found under
``--src`` (default ``src``; point it at an older tree's ``src`` to count
that one) on meta tensors, so nothing is allocated and any size fits,
and counts each tensor the autograd graph saves
(``saved_tensors_hooks``), once per save.  The default shape is
smollm-360m FULL's attention at B 1 x S 4096 in float32.  A count from
shapes: the same on any device.
"""
import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--src", default="src")
    ap.add_argument("--shape", type=int, nargs=5, default=[1, 4096, 15, 5, 64],
                    metavar=("B", "S", "H", "KV", "D"))
    args = ap.parse_args(argv)
    sys.path.insert(0, args.src)
    import torch

    from repro_torch.models import layers as L

    B, S, H, Kv, d = args.shape
    cfg = L.AttnConfig(d_model=H * d, n_heads=H, n_kv_heads=Kv, d_head=d)
    q = torch.empty((B, S, H, d), device="meta", requires_grad=True)
    k, v = (torch.empty((B, S, Kv, d), device="meta", requires_grad=True) for _ in range(2))
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        L._blockwise_attention(q, k, v, cfg, d ** -0.5, False)
    print(json.dumps({"src": args.src, "shape": args.shape, "saved_tensors": len(saved),
                      "saved_bytes": sum(saved), "input_bytes": (q.numel() + 2 * k.numel()) * 4}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
