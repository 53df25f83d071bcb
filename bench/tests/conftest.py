import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# Tiny shapes of the two layouts: the same code paths as the benchmark's
# configurations, at sizes a CPU test run holds.  The compressed layout has
# no configuration in BENCHMARK.json (the program spills plain rMAT there);
# its adapter is kept and run here on test-only cells, in communities that
# keep every delta inside int8, so that no publish spills.
FLAT = {"name": "tiny-flat", "layout": "flat", "log_n": 10, "communities": 1, "n": 1024,
        "graph_draws": 4096, "pool_edges": 16384}
COMPRESSED = {"name": "tiny-compressed", "layout": "compressed", "log_n": 6, "communities": 16,
              "n": 1024, "graph_draws": 8192, "pool_edges": 32768, "hi_headroom": 0.0625}
WRITER = {"generator": "writer", "batch_draws": 256, "ring": 8, "delete_lag": 4, "hold": [2, 6]}
BFS = {"generator": "bfs_closed", "sample": 4, "stale_draws": 512}
PAGERANK = {"generator": "pagerank_closed", "lanes": 8, "iters": 20, "damping": 0.85, "sample": 2,
            "limit_l1": 1e-4}
CELLS = {
    "flat-update-2m": (FLAT, WRITER),
    "flat-bfs": (FLAT, BFS),
    "flat-pagerank8": (FLAT, PAGERANK),
    "test-cmp-update": (COMPRESSED, WRITER),
    "test-cmp-pagerank8": (COMPRESSED, PAGERANK),
}
SEED = 2**31 + 12345


@pytest.fixture
def bm():
    from bench import harness

    return harness.load_benchmark()


@pytest.fixture
def cuda():
    """Skips the test unless a CUDA device is present (decided here, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def run_tiny(bm, cell, device="cpu", trace=False, system=None, seconds=0.3, seed=SEED, **kw):
    from bench import harness

    cfg, cell_mix = CELLS[cell]
    mix = kw.pop("mix", cell_mix)
    if all(w["name"] != cell for w in bm["workloads"]):  # a test-only cell
        bm = dict(bm, workloads=bm["workloads"] + [
            {"name": cell, "config": cfg["name"], "traffic": cell, "chips": 1, "why": "test"}])
    return harness.run_cell(bm, cell, seed, seconds, trace, device=device, cfg=cfg, mix=mix,
                            system=system, log=lambda msg: None, **kw)
