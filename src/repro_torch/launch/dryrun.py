"""Multi-pod dry run: run every (arch x shape x mesh) cell on a fake mesh.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell for 256 or 512 placeholder host devices and reads
XLA's cost and memory analyses.  The port runs each cell's step eagerly
instead, in one process:

  * a default process group on the ``fake`` backend with world size 256
    or 512 (``fake_world``), this process being rank 0 — the counterpart
    of the reference's 512 placeholder devices;
  * the production ``DeviceMesh`` over it (``launch.mesh``), each
    argument a DTensor whose local shard is a meta tensor laid out by the
    cell's spec (``dist.shardings.placements``), so nothing is allocated;
  * ``step_fn`` run on them (training cells include the backward), and
    the outputs redistributed to the cell's ``out_specs``;
  * ``CostMode`` counting, below DTensor's dispatch, the FLOPs and bytes
    of every op on the local shards (per-device figures, as XLA's
    post-SPMD cost analysis gives) and recording every collective that
    DTensor issues (``launch.hlo_analysis``).

The layouts are ``dist.spmd``'s, the program real ranks run with
values: ``CostMode`` is its ``SpmdMode`` plus counting.  Where DTensor
has no layout for an op of the cells, or one that differs between its
releases, ``dist.spmd`` states its own in the manner of the reference's
SPMD partitioner, and never replicates quietly (the strategies of
``spmd.register_strategies``; gathers and scatters masked on each rank's
block; a scatter from entry-sharded updates as local partials and one
all-reduce; a softmax over a sharded dim with all-reduced statistics;
the blockwise attention under ``local_map``; a view DTensor cannot lay
out gathers the one mesh dim in its way).  Any other op DTensor cannot
lay out, or lays out with a local shard that does not match its layout,
fails the cell.  The report counts the resharded views and the masked
ops.

The report keeps the reference's keys and meanings.  XLA's buffer
assignment has no counterpart, so ``mem_argument_bytes`` is the local
shards' size and ``fits`` holds the analytic ``mem_model`` total (the
argument bytes where a cell has no model) against one H100's 80 GB.
Bytes are counted per op (each op's tensor inputs read and outputs
written; a gather reads only the rows it returns; views move nothing),
with no fusion, so they bound XLA's fused count from above.

FLOPs follow XLA's cost analysis: matrix products, convolutions and
attention by torch's ``flop_registry``; a pointwise op one FLOP per
output element and a reduction one per input element, as
``HloCostAnalysis`` counts elementwise and reduce instructions; a
scatter that combines (an add, a max) one per update element.
Transcendentals (``exp``, ``log``, ``tanh``, ``sqrt``, ``pow``, the
sigmoid and its kin) are left out, as XLA counts them apart from its
FLOPs, and so are copies and fills, which XLA does not count.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out dryrun.jsonl
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import traceback
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.flop_counter import flop_registry

from ..configs import registry
from ..dist import shardings as SH
from ..dist import spmd
from . import hlo_analysis
from . import mesh as mesh_lib
from .cells import Cell, build_cell

HBM_BYTES = 80e9  # one H100 SXM

_GATHER_OPS = {"index", "gather", "embedding", "index_select"}
_FREE_OPS = {"empty", "empty_strided", "empty_like", "detach", "alias", "lift_fresh"}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostMode(spmd.SpmdMode):
    """``dist.spmd.SpmdMode`` plus counting: the FLOPs and bytes of the
    ops that run on local tensors of ``device_type`` (the module
    docstring's rules), beside the collectives the mode records.  The
    program is the one real ranks run; only what is counted is added."""

    def __init__(self, device_type: Optional[str] = "meta"):
        super().__init__(device_type)
        self.flops = 0
        self.bytes = 0

    def _count(self, func, args, kwargs, out) -> None:
        ins, outs = spmd._tensors((args, kwargs)), spmd._tensors(out)
        if not self._of_the_run(ins + outs) or func._opname in _FREE_OPS or func.is_view:
            return
        self.flops += _flops(func, args, kwargs, ins, outs, out)
        if func._opname in _GATHER_OPS:
            # a gather reads the rows it returns, not its whole source
            moved = 2 * sum(_nbytes(t) for t in outs) + sum(_nbytes(t) for t in ins[1:])
        else:
            moved = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.bytes += moved

    def _mark(self):
        return (self.flops, self.bytes, len(self.collectives))

    def _rewind(self, mark) -> None:
        # what a failed attempt ran does not count
        self.flops, self.bytes = mark[:2]
        del self.collectives[mark[2]:]


# pointwise ops XLA counts as transcendentals, not FLOPs
_TRANSCENDENTAL = {"exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "sin", "cos",
                   "tan", "tanh", "sigmoid", "erf", "erfc", "erfinv", "pow", "sqrt", "rsqrt",
                   "atan2", "silu", "gelu", "softplus", "logit", "reciprocal"}
_NO_FLOPS = {"clone", "copy", "fill", "zero", "lift_fresh_copy"}
_COMBINING_SCATTERS = {"index_add", "scatter_add", "scatter_reduce", "index_put",
                       "_index_put_impl"}


def _flops(func, args, kwargs, ins, outs, out) -> int:
    """The op's FLOPs as XLA's cost analysis counts them (module
    docstring)."""
    packet = func._overloadpacket
    if packet in flop_registry:
        return int(flop_registry[packet](*args, **kwargs, out_val=out))
    base = func._opname.rstrip("_")
    if base in _NO_FLOPS or base in _TRANSCENDENTAL:
        return 0
    if torch.Tag.pointwise in func.tags or base == "_to_copy":
        return sum(t.numel() for t in outs[:1])
    if torch.Tag.reduction in func.tags:
        return ins[0].numel() if ins else 0
    if base in ("_softmax", "_log_softmax"):
        return 4 * (outs[0].numel() if outs else 0)  # max, subtract, sum, divide
    if base in ("cumsum", "cumprod", "cummax", "cummin"):
        return ins[0].numel() if ins else 0
    if base in _COMBINING_SCATTERS:
        if base.startswith("index_put") or base == "_index_put_impl":
            if not (bool(args[3]) if len(args) > 3 else kwargs.get("accumulate", False)):
                return 0
            idx = [(d, t) for d, t in enumerate(args[1]) if t is not None]
            entries = int(np.prod(torch.broadcast_shapes(*(tuple(t.shape) for _, t in idx)),
                                  dtype=np.int64))
            indexed = int(np.prod([args[0].shape[d] for d, _ in idx], dtype=np.int64))
            return entries * (args[0].numel() // max(indexed, 1))
        src = args[3] if len(args) > 3 and isinstance(args[3], torch.Tensor) else None
        return src.numel() if src is not None else 0
    return 0


@contextlib.contextmanager
def fake_world(world_size: int):
    """A default process group of ``world_size`` ranks on the ``fake``
    backend, this process being rank 0; destroyed on exit.  Collectives
    on it return at once and move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# the cells' arguments laid out by their specs (meta shards of rank 0's
# shape), and the outputs redistributed to their out_specs
distribute = spmd.distribute
_redistribute = spmd.redistribute


def local_arg_bytes(cell: Cell, mesh) -> int:
    """Bytes of rank 0's shards of the cell's arguments."""
    total = 0

    def one(spec, t):
        nonlocal total
        local = SH.local_shape(t.shape, spec, mesh)
        total += int(np.prod(local, dtype=np.int64)) * t.element_size()

    SH.map_specs(one, cell.in_specs, cell.args)
    return total


def _step(cell: Cell, mesh):
    """The cell's step as DTensors see it.  The shard-local stream
    update (``variant="shardmap"``) runs under ``local_map`` with its
    specs' placements: each rank merges into its own rows, the
    counterpart of the reference's ``shard_map``."""
    if cell.meta.get("variant") != "shardmap":
        return cell.step_fn
    from torch.distributed.tensor.experimental import local_map

    pool_specs, batch_spec = cell.in_specs
    # one entry per flattened leaf: data, n, lo and the absent value lane
    pool_pl = tuple(SH.placements(mesh, s) for s in pool_specs[:3]) + (None,)
    return local_map(cell.step_fn, out_placements=pool_pl,
                     in_placements=pool_pl + (SH.placements(mesh, batch_spec),),
                     device_mesh=mesh)


def measure(cell: Cell, mesh) -> Dict[str, object]:
    """Run ``cell`` on ``mesh`` (its DTensors on ``mesh.spmd_mesh``) and
    count its per-device costs."""
    from torch.distributed.tensor.experimental import implicit_replication

    on = mesh_lib.spmd_mesh(mesh)
    args = distribute(cell.args, cell.in_specs, mesh, on)
    t0 = time.time()
    # a plain tensor the step makes itself (an arange, a mask) is a
    # replicated constant, as in the reference's SPMD program
    with implicit_replication(), CostMode() as cm:
        out = _step(cell, on)(*args)
        if cell.out_specs is not None:
            _redistribute(out, cell.out_specs, on)
    run_s = time.time() - t0
    coll_total, coll_kinds = hlo_analysis.collective_bytes(cm.collectives)
    links = hlo_analysis.bytes_by_link(cm.collectives)
    return {"flops": float(cm.flops), "bytes": float(cm.bytes), "coll": float(coll_total),
            "kinds": coll_kinds, "links": links, "resharded": dict(cm.resharded),
            "masked": dict(cm.masked),
            "run_s": run_s}


def run_cell(arch: str, shape: str, multi_pod: bool, reduced: bool = False,
             host: bool = False, **build_kw) -> dict:
    """Build ``arch``/``shape`` at full width (REDUCED with ``reduced``) on
    the 256-rank (or 512-rank) fake mesh, or with ``host`` on the 1x1
    mesh, run its step and report the reference's dry-run keys."""
    n_chips = 1 if host else 512 if multi_pod else 256
    with fake_world(n_chips):
        mesh = (mesh_lib.make_host_mesh() if host
                else mesh_lib.make_production_mesh(multi_pod=multi_pod))
        t0 = time.time()
        cell = build_cell(arch, shape, mesh, reduced=reduced, **build_kw)
        build_s = time.time() - t0
        c = measure(cell, mesh)
        arg_bytes = local_arg_bytes(cell, mesh)

    compute_s = c["flops"] / mesh_lib.PEAK_FLOPS_BF16
    memory_s = c["bytes"] / mesh_lib.HBM_BW
    collective_s = (c["links"]["nvlink"] / mesh_lib.NVLINK_BW
                    + c["links"]["network"] / mesh_lib.NET_BW)
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    model_flops = cell.meta.get("model_flops", 0.0)
    useful = model_flops / (n_chips * c["flops"]) if c["flops"] else 0.0
    mem_model = cell.meta.get("mem_model")
    mem_total = mem_model["total"] if mem_model else float(arg_bytes)
    return {
        "arch": arch,
        "shape": shape,
        "mesh": "1x1" if host else "2x16x16" if multi_pod else "16x16",
        "n_chips": n_chips,
        "ok": True,
        "reduced": reduced,
        "build_s": round(build_s, 2),
        "run_s": round(c["run_s"], 2),
        "flops_per_dev": c["flops"],
        "bytes_per_dev": c["bytes"],
        "collective_bytes_per_dev": c["coll"],
        "collective_kinds": c["kinds"],
        "collective_links": c["links"],
        "resharded_views": c["resharded"],
        "masked_local_ops": c["masked"],
        "compute_s_term": compute_s,
        "memory_s_term": memory_s,
        "collective_s_term": collective_s,
        "dominant": dominant.replace("_s", ""),
        "model_flops": model_flops,
        "useful_compute_frac": useful,
        "mem_argument_bytes": arg_bytes,
        "mem_model": mem_model,
        "fits": bool(mem_total <= HBM_BYTES),
        "fits_by": "mem_model" if mem_model else "mem_argument_bytes",
        "meta": {k: v for k, v in cell.meta.items() if isinstance(v, (int, float, str, bool))},
    }


def _ok_line(tag: str, res: dict) -> str:
    mem = res["mem_model"]["total"] if res["mem_model"] else res["mem_argument_bytes"]
    return (f"[OK] {tag}: run={res['run_s']}s dominant={res['dominant']} "
            f"terms(c/m/x)=({res['compute_s_term']:.2e},"
            f"{res['memory_s_term']:.2e},{res['collective_s_term']:.2e}) "
            f"mem={mem / 2**30:.2f}GiB/dev fits={res['fits']} "
            f"useful={res['useful_compute_frac']:.3f}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true", help="run every assigned cell")
    ap.add_argument("--include-stream", action="store_true")
    ap.add_argument("--reduced", action="store_true", help="the REDUCED configs")
    ap.add_argument("--out", default=None, help="append JSON lines here")
    args = ap.parse_args(argv)

    if args.all:
        cells = list(registry.all_cells(include_stream=args.include_stream))
    else:
        if not args.arch:
            ap.error("--arch required unless --all")
        spec = registry.get(args.arch)
        shapes = [args.shape] if args.shape else list(spec.shapes)
        cells = [(args.arch, s) for s in shapes]

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            tag = f"{arch}/{shape}/{'2x16x16' if mp else '16x16'}"
            try:
                res = run_cell(arch, shape, mp, reduced=args.reduced)
                print(_ok_line(tag, res), flush=True)
            except Exception as e:  # noqa: BLE001 - report and continue
                failures += 1
                res = {"arch": arch, "shape": shape,
                       "mesh": "2x16x16" if mp else "16x16",
                       "ok": False, "error": f"{type(e).__name__}: {e}"}
                print(f"[FAIL] {tag}: {type(e).__name__}: {str(e)[:300]}", flush=True)
                traceback.print_exc(file=sys.stderr)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(res) + "\n")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
