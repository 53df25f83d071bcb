"""The harness: finds a cell's configuration, mix, generator, layout and
metric readers by name, runs the cell once and builds its result line.

Everything that belongs to one configuration, mix or metric sits in files
of its own, found by the names in ``BENCHMARK.json``:

- ``configs/<config>.json`` (the ``file`` of the configuration's entry):
  sizes, the ``layout`` and the guarantees;
- ``layouts/<layout>.py``: the system under test, through the port's
  calls: build, publish, settle, engine, storages and the judged view of
  a version of that layout;
- ``mixes/<traffic>.json``: the mix's parameters and its ``generator``;
- ``traffic/<generator>.py``: ``prepare``, ``window`` and ``judge``;
- ``metrics/<metric>.py`` (or ``metrics/<part before the first dot>.py``):
  ``read(run, name)``, the metric's value or None.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import gen
from .calls import CallLog
from .trace import Tracer, breakdown, busy_s, window_s

BANNED = ("jax", "jaxlib", "flax", "repro")  # top-level module names the run may not hold
ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# discovery
# ---------------------------------------------------------------------------


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(bm: dict, name: str, root: Path = ROOT) -> dict:
    with open(root / find(bm["configs"], name, "configuration")["file"]) as f:
        return json.load(f)


def load_mix(name: str, root: Path = ROOT) -> dict:
    with open(root / "bench" / "mixes" / f"{name}.json") as f:
        return json.load(f)


def _load_file(path: Path, modname: str):
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_module(kind: str, name: str, root: Path = ROOT):
    """``bench/<kind>/<name>.py`` as ``bench.<kind>.<name>`` (its relative
    imports resolve inside the package)."""
    path = root / "bench" / kind / f"{name}.py"
    if not path.is_file() or path.resolve().parent == (ROOT / "bench" / kind).resolve():
        return importlib.import_module(f"bench.{kind}.{name}")
    return _load_file(path, f"bench.{kind}.{name}")


def metric_reader(name: str, root: Path = ROOT):
    for base in (root / "bench" / "metrics", ROOT / "bench" / "metrics"):
        path = base / f"{name}.py"
        if not path.is_file():
            path = base / f"{name.split('.')[0]}.py"
        if path.is_file():
            break
    return _load_file(path, f"bench_metric_{path.stem.replace('.', '_')}")


def cell_metrics(bm: dict, cell: str, section: str) -> list:
    """The metrics of ``section`` (``end_to_end`` or ``per_layer``) the cell reports."""
    return [m for m in bm[section] if "workloads" not in m or cell in m["workloads"]]


# ---------------------------------------------------------------------------
# a run's context
# ---------------------------------------------------------------------------


class Context:
    def __init__(self, cfg, mix, seed, device, system, tracer, log):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, int(seed), torch.device(device)
        self.system, self.span, self.log = system, tracer.span, log
        self.parts = {}
        self.keys = self.version = self.m = self.engine = None


def program_counters() -> dict:
    from repro_torch.core.traversal import HOST_SYNCS
    from repro_torch.kernels import delta_decode, segment_reduce

    return {"host_syncs": HOST_SYNCS.count,
            "launches": {**segment_reduce.LAUNCHES, **delta_decode.LAUNCHES}}


def _since(before: dict, after: dict) -> dict:
    return {"host_syncs": after["host_syncs"] - before["host_syncs"],
            "launches": {k: v - before["launches"].get(k, 0)
                         for k, v in after["launches"].items()
                         if v - before["launches"].get(k, 0)}}


def tiles() -> dict:
    """The launch tiles the program's autotuner holds for this checkout
    (its table at ``REPRO_TORCH_AUTOTUNE_CACHE``), so that a run whose
    tiles differ from another's shows it."""
    path = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    try:
        with open(path) as f:
            return json.load(f)
    except (TypeError, OSError, ValueError):
        return {}


def _stderr(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------


def run_cell(bm: dict, cell: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_process: float | None = None, cfg: dict | None = None, mix: dict | None = None,
             system=None, root: Path = ROOT, log=_stderr) -> dict:
    """Run ``cell`` once: set-up, the measured window, the check against
    the reference.  Returns ``{"result": the result line's object, "checks":
    name -> (value, limit), "run": the record the metric readers read}``."""
    t_begin = time.perf_counter() if t_process is None else t_process
    entry = find(bm["workloads"], cell, "workload")
    cfg = load_config(bm, entry["config"], root) if cfg is None else cfg
    mix = load_mix(entry["traffic"], root) if mix is None else mix
    traffic = load_module("traffic", mix["generator"], root)
    if system is None:
        system = load_module("layouts", cfg["layout"], root)
    cuda = torch.device(device).type == "cuda"
    tracer = Tracer(trace, cuda)
    ctx = Context(cfg, mix, seed, device, system, tracer, log)

    t = time.perf_counter()
    keys = gen.graph_keys(cfg, ctx.seed, ctx.device)
    ctx.keys = keys.cpu().numpy()
    del keys
    ctx.parts["generate_s"] = time.perf_counter() - t
    t = time.perf_counter()
    ctx.version = system.build(cfg, ctx.keys, ctx.device)
    ctx.m, _ = system.settle(ctx.version)
    ctx.parts["build_s"] = time.perf_counter() - t
    traffic.prepare(ctx)
    gc.collect()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_begin
    log("setup " + json.dumps({"setup_s": setup_s, "m": ctx.m, **ctx.parts}))
    log("tiles " + json.dumps(tiles(), sort_keys=True))

    calls = CallLog()
    before = program_counters()
    if trace:
        calls.install()
    tracer.start()
    try:
        with ctx.span("window"):
            rec = traffic.window(ctx, seconds)
    finally:
        tr = tracer.stop()
        calls.uninstall()
    rec["counters"] = _since(before, program_counters())
    ms = np.array([1e3 * (op["t1"] - op["t0"]) for op in rec["ops"]])
    log("ops " + json.dumps({"n": int(ms.size), "median_ms": float(np.median(ms)),
                             "p05_ms": float(np.percentile(ms, 5)),
                             "p95_ms": float(np.percentile(ms, 95)),
                             "first_ms": ms[:5].tolist(), "last_ms": ms[-5:].tolist(),
                             "mean_ms_by_fifth": [float(c.mean()) for c in
                                                  np.array_split(ms, 5) if c.size]}))
    peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    rec.update(setup_s=setup_s, window_s=rec["t_end"] - rec["t_start"], trace=tr,
               decode_work=calls.work("decode"), segsum_work=calls.work("segsum"))
    del calls
    t = time.perf_counter()
    checks = traffic.judge(ctx, rec)
    log(f"check_s {time.perf_counter() - t}")
    kind = torch.cuda.get_device_name(ctx.device) if cuda else "cpu"
    rec["device_kind"] = kind
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for spec in cell_metrics(bm, cell, section):
        val = metric_reader(spec["name"], root).read(rec, spec["name"])
        if val is not None:
            metrics[spec["name"]] = {"value": val, "unit": spec["unit"]}
    correct = all(lim is not None and val <= lim for val, lim in checks.values())
    device = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
              "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": rec["attempted"], "failed": rec["failed"],
              "metrics": metrics, "device": device}
    if trace:
        device.update(busy_s=busy_s(tr) if tr else 0.0, window_s=window_s(tr) if tr else 0.0)
        if tr is not None:
            result["breakdown"] = breakdown(tr)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return {"result": result, "checks": checks, "run": rec}


def banned_modules() -> list:
    """Modules in this process whose top-level name is banned (compared whole)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


def json_default(x):
    if isinstance(x, (np.integer,)):
        return int(x)
    if isinstance(x, (np.floating,)):
        return float(x)
    raise TypeError(type(x))
