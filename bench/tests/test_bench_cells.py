"""Each traffic generator against the plain reference at a tiny size (on the
kernels' plain versions), its control, and the faults the check must catch."""
import numpy as np
import pytest
import torch
from conftest import CELLS, run_tiny

from bench.controls import Control

WRITERS = ("flat-update-2m", "test-cmp-update")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_correct_against_reference(bm, cell):
    out = run_tiny(bm, cell)
    res = out["result"]
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    names = {m["name"] for m in bm["end_to_end"]
             if "workloads" not in m or cell in m["workloads"]}
    assert set(res["metrics"]) == names
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(bm, cell):
    res = run_tiny(bm, cell, system=Control())["result"]
    assert not res["correct"], res["checks"]


def _fault_state_unchanged(mp):
    from repro_torch.core import flat_graph as fg

    mp.setattr(fg, "insert_edges_device", lambda g, batch, out_cap=None, n_out=None: g)
    mp.setattr(fg, "insert_edges_compressed", lambda cg, batch, out_cap, n_out=None: cg)


def _fault_half_batch(mp):
    from repro_torch.core import flat_ctree as fct

    orig = fct.from_device

    def half(values, cap, vals=None):
        v = values.clone()
        v[v.numel() // 4: v.numel() // 2] = fct.SENTINEL64
        return orig(v, cap, vals)
    mp.setattr(fct, "from_device", half)


def _fault_key_altered(mp):
    from repro_torch.core import flat_graph as fg

    ins, ins_c = fg.insert_edges_device, fg.insert_edges_compressed

    def flat(g, batch, out_cap=None, n_out=None):
        out = ins(g, batch, out_cap, n_out=n_out)
        keys = out.keys.clone()
        keys[3] += 1
        return out._replace(keys=keys)

    def compressed(cg, batch, out_cap, n_out=None):
        out = ins_c(cg, batch, out_cap, n_out)
        anchors = out.dst.anchors.clone()
        anchors[0] += 1
        return out._replace(dst=out.dst._replace(anchors=anchors))
    mp.setattr(fg, "insert_edges_device", flat)
    mp.setattr(fg, "insert_edges_compressed", compressed)


@pytest.mark.parametrize("cell", WRITERS)
@pytest.mark.parametrize("fault", [_fault_state_unchanged, _fault_half_batch, _fault_key_altered],
                         ids=["state_unchanged", "half_batch", "key_altered"])
def test_writer_fault_is_caught(bm, cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run_tiny(bm, cell)["result"]
    assert not res["correct"], res["checks"]


def _alter(par, src):
    par = np.array(par, copy=True)
    v = int(np.flatnonzero((par >= 0) & (np.arange(par.size) != src))[-1])
    par[v] = v  # a vertex named its own parent
    return par


def test_bfs_answer_altered_is_caught(bm, monkeypatch):
    from repro_torch.core.traversal import algorithms as talg

    orig_multi = talg.bfs_multi

    def bfs_multi(engine, sources, direction_optimize=True):
        par, dep = orig_multi(engine, sources, direction_optimize)
        return np.stack([_alter(p, s) for p, s in zip(par, sources)]), dep
    monkeypatch.setattr(talg, "bfs_multi", bfs_multi)
    res = run_tiny(bm, "flat-bfs")["result"]
    assert not res["correct"]
    assert res["checks"]["parent_errors"]["value"] > 0


@pytest.mark.parametrize("cell", ["flat-pagerank8", "test-cmp-pagerank8"])
def test_pagerank_answer_altered_is_caught(bm, cell, monkeypatch):
    from repro_torch.core.traversal import algorithms as talg

    orig = talg.pagerank_multi

    def pagerank_multi(engine, resets=None, **kw):
        pr = np.array(orig(engine, resets, **kw), copy=True)
        pr[0, int(np.argmax(pr[0]))] += 1e-3
        return pr
    monkeypatch.setattr(talg, "pagerank_multi", pagerank_multi)
    res = run_tiny(bm, cell)["result"]
    assert not res["correct"]
    assert res["checks"]["pagerank_l1"]["value"] > res["checks"]["pagerank_l1"]["limit"]


def test_same_seed_same_inputs():
    from bench import gen

    cfg = CELLS["flat-update-2m"][0]
    a = gen.graph_keys(cfg, 2**31 + 7, "cpu")
    b = gen.graph_keys(cfg, 2**31 + 7, "cpu")
    c = gen.graph_keys(cfg, 2**31 + 8, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert bool((a[1:] > a[:-1]).all()) and not bool(((a >> 32) == (a & 0xFFFFFFFF)).any())


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_on_the_card(bm, cell, cuda):
    """The tiny cells through the CUDA kernels, traced: correct, and the control not."""
    out = run_tiny(bm, cell, device="cuda", trace=True, seconds=1.0)
    assert out["result"]["correct"], out["result"]["checks"]
    assert out["result"]["device"]["busy_s"] > 0
    assert not run_tiny(bm, cell, device="cuda", system=Control())["result"]["correct"]
