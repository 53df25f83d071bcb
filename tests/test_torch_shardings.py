"""The port's sharding rules (``repro_torch.dist.shardings``) against the
reference's (``repro/dist/shardings.py``), entry for entry.

Every rule is a pure function of (config, mesh shape), so both packages
take the same fake meshes: 1x1, 16x16 and 2x16x16.  Each of the 11 arch
ids' FULL and REDUCED configs goes through the rules of its family:
the LM parameter specs (raw and reconciled with the parameter tree),
ZeRO-1 over the LM parameter shapes, the data specs, the KV-cache specs
with and without ``seq_shard`` at batch sizes 1 and 128; the GNN batch
specs; the DCN parameter specs over its parameter shapes.  The
parameter shapes are the reference's ``eval_shape`` and the port's init
on the meta device.  ``placements`` is held on a fake process group:
the local shards of a DTensor laid out by a spec divide as the spec says.
"""
import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import registry as jreg
from repro.dist import shardings as JSH
from repro.models import transformer as JT
from repro.models.recsys import dcn_v2 as jdcn
from repro_torch.configs import registry as treg
from repro_torch.dist import shardings as TSH
from repro_torch.launch import cells as tcells
from repro_torch.models.recsys import dcn_v2 as tdcn


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)


MESHES = {
    "1x1": {"data": 1, "model": 1},
    "16x16": {"data": 16, "model": 16},
    "2x16x16": {"pod": 2, "data": 16, "model": 16},
}


def norm(tree):
    """A spec tree of either package as plain nested Python: a spec leaf
    becomes ("spec", its entries)."""
    if isinstance(tree, (JP, TSH.Spec)):
        return ("spec", tuple(tree))
    if isinstance(tree, dict):
        return {k: norm(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [norm(v) for v in tree]
    return tree


def same(port, ref):
    assert norm(port) == norm(ref)


def _jshapes(fn):
    return jax.eval_shape(fn)


def _lm_rules(a, full, mesh_shape):
    jcfg = jreg.get(a).full if full else jreg.get(a).reduced
    tcfg = treg.get(a).full if full else treg.get(a).reduced
    jm, tm = FakeMesh(mesh_shape), FakeMesh(mesh_shape)
    same(TSH.lm_param_specs(tcfg, tm), JSH.lm_param_specs(jcfg, jm))
    jparams = _jshapes(lambda: JT.init_params(jax.random.PRNGKey(0), jcfg))
    tparams = tcells._lm_params(tcfg)
    jp = JSH.spec_tree_like(JSH.lm_param_specs(jcfg, jm), jparams)
    tp = TSH.spec_tree_like(TSH.lm_param_specs(tcfg, tm), tparams)
    same(tp, jp)
    same(TSH.zero1_specs(tp, tparams, tm), JSH.zero1_specs(jp, jparams, jm))
    same(TSH.lm_data_specs(tm), JSH.lm_data_specs(jm))
    for seq_shard in (False, True):
        for bs in (1, 128):
            same(TSH.lm_cache_specs(tcfg, tm, seq_shard=seq_shard, batch_size=bs),
                 JSH.lm_cache_specs(jcfg, jm, seq_shard=seq_shard, batch_size=bs))


def _gnn_rules(mesh_shape):
    jm, tm = FakeMesh(mesh_shape), FakeMesh(mesh_shape)
    for shard_nodes in (False, True):
        same(TSH.gnn_batch_specs(tm, shard_nodes), JSH.gnn_batch_specs(jm, shard_nodes))
    same(TSH.sage_sampled_specs(tm), JSH.sage_sampled_specs(jm))


def _dcn_rules(full, mesh_shape):
    cfg = treg.get("dcn-v2").full if full else treg.get("dcn-v2").reduced
    kw = dict(n_dense=cfg.n_dense, n_sparse=cfg.n_sparse, embed_dim=cfg.embed_dim,
              vocab_per_field=cfg.vocab_per_field, n_cross=cfg.n_cross,
              mlp_dims=cfg.mlp_dims, n_candidates=cfg.n_candidates)
    jparams = _jshapes(lambda: jdcn.init(jax.random.PRNGKey(0), **kw))
    tparams = tdcn.init(None, device="meta", **kw)
    jm, tm = FakeMesh(mesh_shape), FakeMesh(mesh_shape)
    jp, tp = JSH.dcn_param_specs(jparams, jm), TSH.dcn_param_specs(tparams, tm)
    same(tp, jp)
    same(TSH.zero1_specs(tp, tparams, tm), JSH.zero1_specs(jp, jparams, jm))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("full", [True, False], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", list(jreg.ARCH_IDS))
def test_rules_match_reference(arch, full, mesh):
    shape = MESHES[mesh]
    assert TSH.batch_axes(FakeMesh(shape)) == JSH.batch_axes(FakeMesh(shape))
    family = treg.get(arch).family
    assert family == jreg.get(arch).family
    if family == "lm":
        _lm_rules(arch, full, shape)
    elif family == "gnn":
        _gnn_rules(shape)
    elif family == "recsys":
        _dcn_rules(full, shape)
    # the stream family has no rule of its own: its cells take batch_axes


def test_spec_tree_like_drops_and_replicates():
    specs = {"a": TSH.P("model"), "gone": TSH.P(None), "sub": {"b": TSH.P(None, "model")}}
    tree = {"a": torch.empty(4), "c": torch.empty(2), "sub": {"b": torch.empty(2, 4)},
            "items": [torch.empty(3)]}
    jspecs = {"a": JP("model"), "gone": JP(None), "sub": {"b": JP(None, "model")}}
    jtree = {"a": np.empty(4), "c": np.empty(2), "sub": {"b": np.empty((2, 4))},
             "items": [np.empty(3)]}
    same(TSH.spec_tree_like(specs, tree), JSH.spec_tree_like(jspecs, jtree))


@pytest.mark.parametrize("spec,local", [
    (TSH.P(("data",), None), (32, 64)),
    (TSH.P(None, "model"), (128, 16)),
    (TSH.P(("data", "model"), None), (8, 64)),
    (TSH.P("model", ("data",)), (32, 16)),
    (TSH.P(), (128, 64)),
])
def test_placements_shard_as_the_spec_says(spec, local):
    """A 4x4 mesh on the fake process group: the DTensor built from a
    local shard of the shape ``local_shape`` gives, carries the global
    shape, and its placements name the spec's tensor dims."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.launch.dryrun import fake_world

    with fake_world(16):
        mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
        assert TSH.axis_sizes(mesh) == {"data": 4, "model": 4}
        assert TSH.local_shape((128, 64), spec, mesh) == local
        pl = TSH.placements(mesh, spec)
        x = DTensor.from_local(torch.empty(local, device="meta"), mesh, pl, run_check=False)
        assert tuple(x.shape) == (128, 64)
        for name, p in zip(mesh.mesh_dim_names, pl):
            named = [d for d, e in enumerate(spec) if e == name or
                     (isinstance(e, tuple) and name in e)]
            assert (isinstance(p, Shard) and [p.dim] == named) or (not named and p.is_replicate())
