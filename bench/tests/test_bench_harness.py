"""The harness: discovery by name, files added without an edit, the
result line, names and units, BENCHMARK.json against the contract, the
trace reduction, and the modules a run loads."""
import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
from conftest import CELLS, ROOT, SEED, run_tiny

from bench import harness, trace

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BANNED = {"jax", "jaxlib", "flax", "repro"}


def test_finds_config_mix_and_metric_by_name(bm):
    cfg = harness.load_config(bm, "aspen-stream-flat")
    assert cfg["layout"] == "flat" and cfg["n"] == 1 << 25
    assert harness.load_mix("writer-2e20")["generator"] == "writer"
    for w in bm["workloads"]:
        mix = harness.load_mix(w["traffic"])
        assert harness.load_module("traffic", mix["generator"]).judge, w["name"]
    assert harness.load_module("traffic", "bfs_closed").window
    assert harness.load_module("layouts", "compressed").publish
    for m in bm["end_to_end"] + bm["per_layer"]:
        assert callable(harness.metric_reader(m["name"]).read), m["name"]


def test_new_cell_added_as_files_only(bm, tmp_path):
    """A configuration, a mix, a generator and a metric added as new files
    and entries are found and run, with no file of the harness edited."""
    (tmp_path / "bench" / "configs").mkdir(parents=True)
    for sub in ("mixes", "traffic", "metrics"):
        (tmp_path / "bench" / sub).mkdir()
    cfg = dict(CELLS["flat-bfs"][0], name="new-config")
    (tmp_path / "bench/configs/new-config.json").write_text(json.dumps(cfg))
    (tmp_path / "bench/mixes/new-mix.json").write_text(
        json.dumps(dict(CELLS["flat-bfs"][1], generator="new_generator")))
    (tmp_path / "bench/traffic/new_generator.py").write_text(
        "from bench.traffic.bfs_closed import prepare, window, judge  # noqa: F401\n")
    (tmp_path / "bench/metrics/new_metric.py").write_text(
        "def read(run, name):\n    return float(len(run['ops']))\n")
    bm = json.loads(json.dumps(bm))
    bm["configs"].append({"name": "new-config", "source": "x", "reduced": [], "why": "x",
                          "file": "bench/configs/new-config.json"})
    bm["workloads"].append({"name": "new-cell", "config": "new-config", "traffic": "new-mix",
                            "chips": 1, "why": "x"})
    bm["per_layer"].append({"name": "new_metric", "unit": "ops", "better": "higher",
                            "source": "host_clock", "layer": "x", "moves": "queries_per_s.bfs",
                            "workloads": ["new-cell"]})
    out = harness.run_cell(bm, "new-cell", SEED, 0.2, True, device="cpu", root=tmp_path,
                           log=lambda m: None)
    assert out["result"]["correct"]
    assert out["result"]["metrics"]["new_metric"]["value"] == len(out["run"]["ops"])


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(bm, traced):
    res = run_tiny(bm, "flat-update-2m", trace=traced)["result"]
    want = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if traced
                                                                      else [])
    assert list(res) == want + ["checks"]
    line = json.loads(json.dumps(res, default=harness.json_default))
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        per_layer = {m["name"] for m in harness.cell_metrics(bm, "flat-update-2m", "per_layer")}
        assert set(line["metrics"]) <= per_layer
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}


def test_benchmark_json_meets_the_contract(bm):
    top = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert set(bm) == top
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= bm["run_seconds"] <= 51 and isinstance(bm["run_seconds"], int)
    assert bm["paths"] == ["bench"] and len(bm["command"]) <= 32
    names = []

    def line(s):
        assert isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s

    for c in bm["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        line(c["source"]), line(c["why"])
        assert c["file"].startswith("bench/") and (ROOT / c["file"]).is_file()
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["name"] == c["name"]
        assert "guarantees" in cfg and "assumed" in cfg
        names.append(c["name"])
    pairs = set()
    for w in bm["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and w["config"] in names
        assert (ROOT / "bench/mixes" / f"{w['traffic']}.json").is_file()
        line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    cells = [w["name"] for w in bm["workloads"]]
    assert sum(w["chips"] == 4 for w in bm["workloads"]) <= max(1, len(cells) // 4)
    e2e = {m["name"]: m for m in bm["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bm["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in bm["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        line(m["layer"])
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)
    for m in bm["end_to_end"] + bm["per_layer"]:
        assert m["better"] in ("lower", "higher") and UNIT.match(m["unit"]), m
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for cell in cells:
        reported = [m["name"] for m in harness.cell_metrics(bm, cell, "end_to_end")]
        assert "setup_s" in reported and len(reported) >= 2
        assert harness.cell_metrics(bm, cell, "per_layer")
    all_names = (names + cells + [w["traffic"] for w in bm["workloads"]]
                 + [m["name"] for m in bm["end_to_end"] + bm["per_layer"]]
                 + [k for c in bm["configs"] for k in c["reduced"]])
    for n in all_names:
        assert NAME.match(n), n
    for group in (names, cells, list(e2e) + [m["name"] for m in bm["per_layer"]]):
        assert len(group) == len(set(group))


def test_trace_reduction():
    doc = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.query", "ts": 10, "dur": 40},
        {"ph": "X", "cat": "user_annotation", "name": "bench.publish.pack", "ts": 60, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "void tile_d1_kernel<1>(Keys)", "ts": 12, "dur": 8},
        {"ph": "X", "cat": "kernel", "name": "fixup_kernel", "ts": 18, "dur": 4},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 30, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "late", "ts": 95, "dur": 20},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 12, "dur": 2},
    ]}
    tr = trace.parse(doc)
    assert tr.window == (0.0, 100.0)
    assert trace.busy_s(tr) == pytest.approx((10 + 10 + 5) / 1e6)
    bd = trace.breakdown(tr)
    idle = dict(bd["idle_gaps"])
    assert idle["publish.pack"] == pytest.approx(20 / 1e6)
    assert sum(idle.values()) == pytest.approx(75 / 1e6)
    assert bd["device_ops"][0] == ["Memcpy DtoH", pytest.approx(10 / 1e6)]
    run = {"trace": tr, "ops": [{"kind": "query", "answers": 2, "t0": 0, "t1": 1}],
           "device_kind": "NVIDIA H100 80GB HBM3", "segsum_work": [(3.35e12 * 6e-6, 0)]}
    reader = harness.metric_reader("copy_ms_per_query.bfs")
    assert reader.read(run, "copy_ms_per_query.bfs") == pytest.approx(10 / 2 / 1e3)
    roof = harness.metric_reader("segment_sum_roofline")
    assert roof.read(run, "segment_sum_roofline") == pytest.approx(100 * 6 / 12)
    assert harness.metric_reader("idle_pct.bfs").read(run, "idle_pct.bfs") == \
        pytest.approx(75.0)
    assert roof.read(dict(run, device_kind="cpu"), "segment_sum_roofline") is None


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in (ROOT / "bench").rglob("*.py"):
        assert not (_imports(path) & BANNED), path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "bench" / "reference").rglob("*.py"):
        assert "repro_torch" not in _imports(path) and not (_imports(path) & BANNED), path
    code = ("import sys; sys.path[:0] = ['src', '.'];"
            "import bench.reference.sets, bench.reference.codec, bench.reference.bfs,"
            " bench.reference.pagerank;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & {'repro_torch', 'repro'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr


def test_a_run_loads_no_jax_module():
    """Every cell's run, in a fresh process: nothing in sys.modules whose
    top-level name is jax, jaxlib, flax or repro (``repro_torch`` is not
    ``repro``: names are compared whole)."""
    code = (
        "import sys; sys.path[:0] = ['src', '.', 'bench/tests'];"
        "from conftest import CELLS, run_tiny; from bench import harness;"
        "bm = harness.load_benchmark();"
        "[run_tiny(bm, c, seconds=0.1, trace=t) for c in CELLS for t in (False, True)];"
        "print(harness.banned_modules(), 'repro_torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_refuses_without_enough_cuda_devices(tmp_path):
    """Without a card (or with fewer than the cell asks for) the command
    exits non-zero and prints no result."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "bench.run", "--workload", "flat-bfs", "--seed",
                          "5", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    """A directory holding only BENCHMARK.json and the benchmark's files
    (no program) gives no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "bench.run", "--workload", "flat-bfs", "--seed",
                          "5", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_kernel_work_from_call_shapes():
    """The roofline's work: each input read once, each output written
    once, from the call's operands (the decode, and a segment sum whose
    dst lane is read compressed, counting only edges that land)."""
    import torch

    from repro_torch.core import compressed as cz

    from bench.calls import CallLog

    s = cz.encode_stream_adaptive(torch.arange(0, 1000, 3, dtype=torch.int32), hi_cap=4)
    R, L = s.deltas.shape
    K = s.ovf_pos.shape[1]
    log = CallLog()
    nb, fl = log._work("delta_decode_chunked_adaptive",
                       (s.anchors, s.deltas, s.hi, s.wide, s.ovf_pos, s.ovf_add))()
    assert nb == s.deltas.numel() + int(s.wide.sum()) * L + (4 + 8 * K + 1) * R + 4 * R * L
    assert fl == R * (L + K)
    msg = torch.ones(R * L, 2)
    nb, fl = log._work("segment_sum_sorted_chunked_adaptive",
                       (s.anchors, s.deltas, s.hi, s.wide, s.ovf_pos, s.ovf_add, msg, 300))()
    landed = 100  # values 0, 3, ..., 297 lie below n_out = 300
    assert fl == landed * 2
    stream = sum(t.numel() * t.element_size() for t in (s.anchors, s.deltas, s.ovf_pos,
                                                        s.ovf_add, s.wide))
    assert nb == stream + int(s.wide.sum()) * L + landed * 4 * 2 + 300 * 4 * 2
