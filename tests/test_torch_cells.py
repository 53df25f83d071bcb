"""The port's cell builders and dry run (``repro_torch.launch``) against
the reference's (``repro/launch/cells.py``, ``dryrun.py``,
``hlo_analysis.py``).

Every cell builds on the 1x1 mesh in both packages: each argument's
shape and dtype width equal the reference's ``ShapeDtypeStruct`` leaf for
leaf, and ``meta["model_flops"]`` and ``meta["mem_model"]`` equal the
reference's to rtol 1e-12.  The nine representative cells of the
reference's ``tests/test_cells.py`` run their step on meta tensors at
1x1, and their outputs have the shapes of the reference's
``eval_shape``.  The dry run's counts are pinned by hand counts on the
fake process group: a recorded all-gather and all-reduce, the
per-device FLOPs of a tensor- and data-parallel MLP on a 16x16 mesh, and
the gathers and scatters the dry run lays out itself; and two cells'
per-device FLOPs are held to the reference's own dry run.  An op that
DTensor cannot lay out, or a fault in a step, fails its cell.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jreg
from repro.launch.cells import build_cell as jbuild
from repro_torch import _tree
from repro_torch.configs import registry as treg
from repro_torch.dist import shardings as SH
from repro_torch.launch import cells as tcells
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch import mesh as mesh_lib
from torch.distributed.tensor import Replicate, Shard

REPRESENTATIVE = [
    ("smollm-360m", "train_4k"),
    ("qwen3-moe-30b-a3b", "decode_32k"),
    ("gcn-cora", "full_graph_sm"),
    ("graphsage-reddit", "minibatch_lg"),
    ("schnet", "molecule"),
    ("graphcast", "molecule"),
    ("dcn-v2", "serve_p99"),
    ("dcn-v2", "retrieval_cand"),
    ("aspen-stream", "update_2m"),
]


@pytest.fixture(scope="module")
def jmesh():
    return jax.make_mesh((1, 1), ("data", "model"))


@pytest.fixture
def host_mesh():
    with dryrun.fake_world(1):
        yield mesh_lib.make_host_mesh()


def test_all_cells_match_reference():
    assert list(treg.all_cells()) == list(jreg.all_cells())
    assert list(treg.all_cells(include_stream=True)) == list(jreg.all_cells(include_stream=True))
    assert len(list(treg.all_cells())) == 40


def _same_leaves(port_tree, ref_tree, widths=True):
    tl, jl = _tree.leaves(port_tree), jax.tree.leaves(ref_tree)
    assert len(tl) == len(jl)
    for t, j in zip(tl, jl):
        assert tuple(t.shape) == tuple(j.shape)
        assert not widths or t.element_size() == np.dtype(j.dtype).itemsize


@pytest.mark.parametrize("arch,shape", list(jreg.all_cells(include_stream=True)))
def test_cell_builds_like_reference(arch, shape, host_mesh, jmesh):
    cell = tcells.build_cell(arch, shape, host_mesh)
    ref = jbuild(arch, shape, jmesh)
    assert all(t.device.type == "meta" for t in _tree.leaves(cell.args))
    _same_leaves(cell.args, ref.args)
    assert cell.meta["model_flops"] == pytest.approx(ref.meta["model_flops"], rel=1e-12)
    if "mem_model" in ref.meta:
        assert set(cell.meta["mem_model"]) == set(ref.meta["mem_model"])
        for k, v in ref.meta["mem_model"].items():
            assert cell.meta["mem_model"][k] == pytest.approx(v, rel=1e-12)
    for k, v in ref.meta.items():
        if isinstance(v, (int, float, str, bool)) and k != "model_flops":
            assert cell.meta[k] == v, k


@pytest.mark.parametrize("variant", ["shardmap", "overlay"])
def test_stream_update_variants(variant, jmesh):
    """The shard-local and overlay update cells build like the
    reference's and run on the 16x16 fake mesh; the shard-local merge
    moves nothing between ranks (its batch arrives replicated)."""
    with dryrun.fake_world(1):
        cell = tcells.build_cell("aspen-stream", "update_2m", mesh_lib.make_host_mesh(),
                                 variant=variant)
    ref = jbuild("aspen-stream", "update_2m", jmesh, variant=variant)
    _same_leaves(cell.args, ref.args)
    assert cell.meta == {k: v for k, v in ref.meta.items()}
    res = dryrun.run_cell("aspen-stream", "update_2m", False, variant=variant)
    assert res["ok"] and res["bytes_per_dev"] > 0
    assert (res["collective_bytes_per_dev"] == 0) == (variant == "shardmap")


def test_lm_cell_meta_math(host_mesh):
    cfg = treg.get("qwen2.5-3b").full
    cell = tcells.build_cell("qwen2.5-3b", "train_4k", host_mesh)
    assert cell.meta["model_flops"] == pytest.approx(6.0 * cfg.param_count() * 256 * 4096)
    mm = cell.meta["mem_model"]
    assert mm["total"] == pytest.approx(sum(v for k, v in mm.items() if k != "total"))


@pytest.mark.parametrize("arch,shape", REPRESENTATIVE)
def test_representative_step_runs_on_meta(arch, shape, host_mesh, jmesh):
    """The step runs at full width on meta tensors (nothing allocated),
    and its outputs have the shapes of the reference's ``eval_shape`` (not
    always its widths: top-k ids are int64 in torch, and the reference's
    SchNet loss is float64, ROADMAP §3)."""
    cell = tcells.build_cell(arch, shape, host_mesh)
    out = cell.step_fn(*cell.args)
    ref = jbuild(arch, shape, jmesh)
    want = jax.eval_shape(ref.step_fn, *ref.args)
    _same_leaves(out, want, widths=False)


def test_shardmap_override_runs_with_its_all_gathers():
    """The ``moe_impl="shardmap"`` override builds and sets
    ``ACTIVE_MESH`` (as the reference's cells do), and qwen3-moe
    ``train_4k`` runs ``ok`` at 16x16 with the block's two all-gathers
    recorded: one layer at full width, since the REDUCED config's 8
    experts do not split over 16 model ranks (the reference's cell
    asserts the same).  The override's collectives are those of the
    einsum block's cell less its masked all-reduces."""
    from repro_torch.models import moe_shardmap as MS

    try:
        with dryrun.fake_world(1):
            host_mesh = mesh_lib.make_host_mesh()
            cell = tcells.build_cell("qwen3-moe-30b-a3b", "train_4k", host_mesh,
                                     reduced=True, overrides={"moe_impl": "shardmap"})
            assert cell.meta["n_layers"] == 2 and MS.ACTIVE_MESH is host_mesh
        kw = dict(n_layers_override=1)
        res = dryrun.run_cell("qwen3-moe-30b-a3b", "train_4k", False,
                              overrides={"moe_impl": "shardmap"}, **kw)
        base = dryrun.run_cell("qwen3-moe-30b-a3b", "train_4k", False, **kw)
    finally:
        MS.ACTIVE_MESH = None
    assert res["ok"] and res["collective_kinds"]["all-gather"] > 0
    assert res["collective_bytes_per_dev"] < base["collective_bytes_per_dev"]


def test_overrides_reach_the_moe_fields(host_mesh):
    cell = tcells.build_cell("qwen3-moe-30b-a3b", "decode_32k", host_mesh, reduced=True,
                             overrides={"moe_dispatch_shards": 4, "moe_shard_dispatch": True},
                             n_layers_override=1)
    assert cell.meta["n_layers"] == 1
    assert cell.args[0]["layers"]["mlp"]["w_gate"].shape[0] == 1


def test_collective_bytes_of_recorded_collectives():
    """An all-gather of bf16 [128, 256] and an all-reduce of f32 [1024],
    recorded by the dry run's dispatch mode on the fake process group."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol

    with dryrun.fake_world(4):
        with dryrun.CostMode(device_type="cpu") as cm:
            g = funcol.all_gather_tensor(torch.zeros(32, 256, dtype=torch.bfloat16), 0,
                                         dist.group.WORLD)
            r = funcol.all_reduce(torch.zeros(1024), "sum", dist.group.WORLD)
            funcol.wait_tensor(g), funcol.wait_tensor(r)
    total, kinds = hlo_analysis.collective_bytes(cm.collectives)
    assert kinds == {"all-gather": 128 * 256 * 2, "all-reduce": 1024 * 4}
    assert total == 65_536 + 4_096
    assert [c.ranks for c in cm.collectives] == [(0, 1, 2, 3)] * 2
    assert hlo_analysis.bytes_by_link(cm.collectives) == {"nvlink": total, "network": 0}


def test_link_pricing():
    assert mesh_lib.link_of(range(8)) == "nvlink"
    assert mesh_lib.link_of(range(16)) == "network"
    assert mesh_lib.link_of([0, 256]) == "network"


def test_tp_dp_mlp_flops_are_per_device():
    """relu(x @ w1) @ w2 with x's batch over ``data`` and the hidden dim
    over ``model`` on a 16x16 mesh: each device multiplies its
    (B/16, D) x (D, F/16) and (B/16, F/16) x (F/16, D) blocks.  The count
    is the local product, not the global 2^33, plus the ReLU's one FLOP
    an element of its local block."""
    from torch.distributed.tensor.experimental import implicit_replication

    B, D, F = 1024, 1024, 4096
    with dryrun.fake_world(256):
        mesh = mesh_lib.make_production_mesh()
        x, w1, w2 = dryrun.distribute(
            (torch.empty(B, D, device="meta"), torch.empty(D, F, device="meta"),
             torch.empty(F, D, device="meta")),
            (SH.P("data", None), SH.P(None, "model"), SH.P("model", None)), mesh)
        with implicit_replication(), dryrun.CostMode() as cm:
            y = torch.relu(x @ w1) @ w2
    assert cm.flops == 2 * (B // 16) * D * (F // 16) * 2 + (B // 16) * (F // 16) == 67_125_248
    assert tuple(y.shape) == (B, D)
    assert cm.collectives == []  # the row-parallel product stays a partial sum


def test_run_cell_reduced_smollm_train():
    res = dryrun.run_cell("smollm-360m", "train_4k", False, reduced=True)
    assert res["ok"] and res["n_chips"] == 256 and res["mesh"] == "16x16"
    assert 0.0 < res["useful_compute_frac"] <= 1.0
    assert res["flops_per_dev"] > 0 and res["bytes_per_dev"] > 0
    assert res["collective_bytes_per_dev"] == sum(res["collective_kinds"].values()) > 0
    assert res["dominant"] in ("compute", "memory", "collective")
    assert res["fits"] and res["mem_model"]["total"] > 0
    assert res["mem_argument_bytes"] > 0


def test_cli_reports_ok_and_fail_and_goes_on(monkeypatch, tmp_path, capsys):
    real = dryrun.run_cell

    def run_cell(arch, shape, multi_pod, reduced=False):
        if shape == "serve_bulk":
            raise ValueError("boom")
        return real(arch, shape, multi_pod, reduced=reduced)

    monkeypatch.setattr(dryrun, "run_cell", run_cell)
    out = tmp_path / "dry.jsonl"
    rc = dryrun.main(["--arch", "dcn-v2", "--reduced", "--out", str(out)])
    text = capsys.readouterr().out
    assert rc == 1
    assert "[FAIL] dcn-v2/serve_bulk/16x16: ValueError: boom" in text
    assert text.count("[OK] dcn-v2/") == 3
    lines = out.read_text().splitlines()
    assert len(lines) == 4


def test_masked_gather_keeps_the_batch_shard_and_counts_local_flops():
    """An embedding lookup from a vocab-sharded table, then a product:
    each device gathers its B/16 tokens' rows from its own V/16 rows
    (masked), sums them over ``model`` (one all-reduce of its (B/16, D)
    block) and multiplies that block, so the product's count is the local
    one, 2 (B/16) D F."""
    from torch.distributed.tensor.experimental import implicit_replication

    B, V, D, F = 256, 1024, 64, 128
    with dryrun.fake_world(256):
        mesh = mesh_lib.make_production_mesh()
        table, tokens, w = dryrun.distribute(
            (torch.empty(V, D, device="meta"), torch.empty(B, dtype=torch.int32, device="meta"),
             torch.empty(D, F, device="meta")),
            (SH.P("model", None), SH.P("data"), SH.P(None, None)), mesh)
        with implicit_replication(), dryrun.CostMode() as cm:
            h = table[tokens.long()]
            mm0 = cm.flops
            y = h @ w
    assert cm.masked == {"index": 1}
    assert tuple(h.placements) == (Shard(0), Replicate())
    assert cm.flops - mm0 == 2 * (B // 16) * D * F
    total, kinds = hlo_analysis.collective_bytes(cm.collectives)
    assert kinds == {"all-reduce": (B // 16) * D * 4}
    assert tuple(y.to_local().shape) == (B // 16, F)


@pytest.mark.parametrize("inplace", [False, True])
def test_index_add_strategies(inplace):
    """A segment sum of edge messages sharded over ``data`` into a
    replicated (n, d) buffer, in place or not: each device adds its E/16
    messages into a partial sum, and one all-reduce over ``data`` merges
    them, as GSPMD partitions the scatter.  The messages and their
    indices are never gathered."""
    from torch.distributed.tensor.experimental import implicit_replication

    E, n, d = 4096, 512, 32
    with dryrun.fake_world(256):
        mesh = mesh_lib.make_production_mesh()
        msg, idx = dryrun.distribute(
            (torch.empty(E, d, device="meta"), torch.empty(E, dtype=torch.int64, device="meta")),
            (SH.P("data", None), SH.P("data")), mesh)
        with implicit_replication(), dryrun.CostMode() as cm:
            zeros = msg.new_zeros((n, d))
            out = zeros.index_add_(0, idx, msg) if inplace else zeros.index_add(0, idx, msg)
            out = out.redistribute(out.device_mesh, [Replicate(), Replicate()])
    _, kinds = hlo_analysis.collective_bytes(cm.collectives)
    assert kinds == {"all-reduce": n * d * 4}
    assert cm.masked == {"scatter_partial": 1}
    assert [len(c.ranks) for c in cm.collectives] == [16]


def test_bool_set_from_sharded_indices_is_one_all_reduce_max():
    """``out[idx] = True`` into a replicated mask with ``idx`` sharded over
    the whole mesh (``dense_expand``'s frontier write): each device sets
    its own entries and one all-reduce MAX over all 256 ranks merges the
    masks, one byte an entry; the E indices are never gathered."""
    from torch.distributed.tensor.experimental import implicit_replication

    E, n = 1 << 16, 4096
    with dryrun.fake_world(256):
        mesh = mesh_lib.make_production_mesh()
        (idx,) = dryrun.distribute((torch.empty(E, dtype=torch.int64, device="meta"),),
                                   (SH.P(("data", "model")),), mesh)
        with implicit_replication(), dryrun.CostMode() as cm:
            out = torch.zeros(n + 1, dtype=torch.bool, device="meta")
            out = dryrun.distribute((out,), (SH.P(None),), mesh)[0]
            out[idx] = True
    _, kinds = hlo_analysis.collective_bytes(cm.collectives)
    assert kinds == {"all-reduce": n + 1}
    assert [len(c.ranks) for c in cm.collectives] == [256]
    assert tuple(out.placements) == (Replicate(), Replicate())


def test_softmax_over_a_sharded_dim_reduces_its_statistics():
    """A softmax over scores whose last dim is sharded over ``model``
    (the sequence of a decode cache): a local max and one all-reduce MAX
    of it, a local sum of the exponentials and one all-reduce SUM, each
    the size of one row statistic; the scores keep their layout and are
    never gathered.  The local count is the max, subtract, sum and
    divide over the local block, one FLOP an element each (the exp is a
    transcendental)."""
    from torch.distributed.tensor.experimental import implicit_replication

    B, S = 64, 4096
    with dryrun.fake_world(256):
        mesh = mesh_lib.make_production_mesh()
        (s,) = dryrun.distribute((torch.empty(B, S, device="meta"),),
                                 (SH.P("data", "model"),), mesh)
        with implicit_replication(), dryrun.CostMode() as cm:
            w = torch.softmax(s, dim=-1)
    _, kinds = hlo_analysis.collective_bytes(cm.collectives)
    assert kinds == {"all-reduce": 2 * (B // 16) * 4}
    assert tuple(w.placements) == (Shard(0), Shard(1))
    local = (B // 16) * (S // 16)
    assert 4 * local <= cm.flops <= 4 * local + 2 * (B // 16)  # + the guard on the max


def test_pointwise_and_reduction_flops():
    """XLA's counts: one FLOP per output element of a pointwise op, one
    per input element of a reduction, none for a transcendental or a
    copy."""
    x = torch.empty(128, 64, device="meta")
    with dryrun.CostMode() as cm:
        y = x * 2 + 1
        z = torch.exp(y)
        z.sum(dim=1)
        y.clone()
    assert cm.flops == 2 * 128 * 64 + 128 * 64


class _Boom(Exception):
    pass


def _raise(x):
    raise _Boom("a fault of the step")


@pytest.mark.parametrize("step,error", [
    (lambda x: torch.renorm(x, 2, 0, 1.0), "does not have a sharding strategy"),
    (lambda x: x @ torch.empty(3, 3, device="meta"), "Sharding propagation failed"),
    (_raise, "a fault of the step"),
])
def test_a_cell_that_cannot_run_fails(monkeypatch, capsys, step, error):
    """No op is replicated to make a cell pass: an op DTensor has no
    layout for (``renorm``), a shape fault and a step that raises each
    give ``[FAIL]`` and a nonzero exit."""
    def build_cell(arch, shape, mesh, reduced=False, **kw):
        return tcells.Cell(step, (torch.empty(256, 8, device="meta"),), (SH.P("data", None),),
                           None, {})

    monkeypatch.setattr(dryrun, "build_cell", build_cell)
    rc = dryrun.main(["--arch", "dcn-v2", "--shape", "serve_p99"])
    text = capsys.readouterr().out
    assert rc == 1
    assert text.startswith("[FAIL] dcn-v2/serve_p99/16x16: ")
    assert error in text


_REF_DRYRUN = """
import json, sys
from repro.launch import dryrun
overrides = json.loads(sys.argv[3]) if len(sys.argv) > 3 else None
r = dryrun.run_cell(sys.argv[1], sys.argv[2], False, reduced=True,
                    **({"overrides": overrides} if overrides else {}))
print(json.dumps({"flops_per_dev": r["flops_per_dev"], "model_flops": r["model_flops"]}))
"""


def _ref_env():
    return dict(os.environ, JAX_PLATFORMS="cpu",
                PYTHONPATH=os.pathsep.join(p for p in sys.path if p))


@pytest.mark.parametrize("arch,shape", [("smollm-360m", "train_4k"),
                                        ("gcn-cora", "full_graph_sm")])
def test_flops_per_dev_near_the_reference_dry_run(arch, shape):
    """The REDUCED cell at 16x16 counts per-device FLOPs within 1.5x of
    the reference's dry run on 256 placeholder host devices (XLA's
    post-SPMD cost analysis).  The LM cell is held against the reference
    with its kv loop unrolled (``attn_impl="chunked_u"``): XLA counts a
    loop body once, so the default count holds one kv step a q block
    (ROADMAP §3).  Both count each kv step's forward again in the
    backward (its checkpoint), and the elementwise work; the port's
    count is 0.87x of it, the GNN cell's 1.00x."""
    overrides = {"attn_impl": "chunked_u"} if arch == "smollm-360m" else None
    done = subprocess.run([sys.executable, "-c", _REF_DRYRUN, arch, shape]
                          + ([json.dumps(overrides)] if overrides else []),
                          env=_ref_env(), capture_output=True, text=True, timeout=600,
                          check=True)
    ref = json.loads(done.stdout.strip().splitlines()[-1])
    res = dryrun.run_cell(arch, shape, False, reduced=True)
    assert res["model_flops"] == pytest.approx(ref["model_flops"], rel=1e-12)
    assert 1 / 1.5 <= res["flops_per_dev"] / ref["flops_per_dev"] <= 1.5
    assert res["flops_per_dev"] >= res["model_flops"] / 256


# The reference's collective bytes, recounted from its compiled HLO: its
# own ``hlo_analysis.collective_bytes`` adds up every line that names a
# collective, the fusions that only read one's result included, so its
# figure holds 2x (query_bfs) to 11.5x (decode_32k) the bytes its
# collective instructions move.  Here only the collective instructions
# count, with the reference's L=1 / L=2 extrapolation for LM cells.
_REF_COLLECTIVES = """
import json, re, sys
from repro.configs import registry
from repro.launch import dryrun, mesh as M
from repro.launch.hlo_analysis import _bytes_of_shape_str

op = re.compile(r"=\\s*(.*?)\\s(all-gather|all-reduce|reduce-scatter|all-to-all|"
                r"collective-permute)(?:-start)?\\(")

def count(compiled):
    return sum(_bytes_of_shape_str(m.group(1)) for m in map(op.search, compiled.as_text()
               .splitlines()) if m)

mesh = M.make_production_mesh()
out = {}
for cell in sys.argv[1:]:
    arch, shape = cell.split("/")
    r = dryrun.run_cell(arch, shape, False, reduced=True)
    cell_, c = dryrun._compile_cell(arch, shape, mesh, reduced=True)
    x = count(c)
    if registry.get(arch).family == "lm":
        L = cell_.meta["n_layers"]
        x1, x2 = (count(dryrun._compile_cell(arch, shape, mesh, reduced=True, unroll=True,
                                             n_layers_override=k)[1]) for k in (1, 2))
        x = max(x, (x2 - x1) * (L - 1) + x1)
    out[cell] = {"collectives": x, "reported": r["collective_bytes_per_dev"],
                 "flops_per_dev": r["flops_per_dev"]}
print(json.dumps(out))
"""

F2_CELLS = [("aspen-stream", "query_bfs"), ("dcn-v2", "train_batch"),
            ("smollm-360m", "decode_32k")]


@pytest.fixture(scope="module")
def ref_collectives():
    done = subprocess.run([sys.executable, "-c", _REF_COLLECTIVES]
                          + [f"{a}/{s}" for a, s in F2_CELLS], env=_ref_env(),
                          capture_output=True, text=True, timeout=600, check=True)
    return json.loads(done.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", F2_CELLS)
def test_collective_bytes_near_the_reference_dry_run(arch, shape, ref_collectives):
    """The REDUCED cell at 16x16 moves per-device collective bytes within
    3x either way of the reference's collective instructions on 256
    placeholder host devices: the frontier write of ``query_bfs`` and
    dcn-v2's embedding gradient go as a local scatter and one all-reduce,
    the decode softmax over the sequence-sharded cache all-reduces its
    row statistics, as GSPMD lays them out.  ``query_bfs`` counts its
    elementwise FLOPs, within 3x of XLA's."""
    ref = ref_collectives[f"{arch}/{shape}"]
    res = dryrun.run_cell(arch, shape, False, reduced=True)
    assert res["ok"]
    assert ref["reported"] >= ref["collectives"] > 0
    assert 1 / 3 <= res["collective_bytes_per_dev"] / ref["collectives"] <= 3
    if arch == "aspen-stream":
        assert res["flops_per_dev"] > 0
        assert 1 / 3 <= res["flops_per_dev"] / ref["flops_per_dev"] <= 3
