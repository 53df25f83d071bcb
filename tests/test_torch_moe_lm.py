"""The MoE LMs (qwen3-moe-30b-a3b, deepseek-moe-16b) on the port: their
configs, three train steps, checkpoints across the packages, the
serving launcher, and on the card a decode through the flash kernel.

The forward, prefill, decode and greedy ``generate`` parity of both
REDUCED configs runs in ``tests/test_torch_lm.py`` (its ``LM_ARCHS``);
the MoE block itself in ``tests/test_torch_moe.py``; ``make_lm_run``
in ``tests/test_torch_launch_train.py``.

Train steps: the reference's jitted step and the port's from the same
parameters (the reference's draws, carried across) on the same token
batches, every parameter and moment after each of three steps to rtol
1e-4, atol 1e-4 * max|leaf| (float32 sums in another order through
AdamW), the loss to rtol 1e-5 (``test_torch_train_step.run_both``).
Checkpoints are compared bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import registry as jreg
from repro.data import pipeline as jpipe
from repro.models import transformer as jT
from repro.optim import adamw as jadamw
from repro.train import train_step as jTS
from repro_torch import _tree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import registry as treg
from repro_torch.kernels import flash_decode as fd
from repro_torch.launch import serve as tlaunch
from repro_torch.models import moe as tM
from repro_torch.models import transformer as tT
from repro_torch.train import train_step as tTS
from test_torch_checkpoint import assert_bits_equal, port_template
from test_torch_train_step import run_both

CPU = "cpu"
MOE_ARCHS = ["qwen3-moe-30b-a3b", "deepseek-moe-16b"]


def test_full_configs_and_param_counts():
    """The FULL configs and the reference's counts (tied embeddings, no
    norm biases): qwen3-moe 29.77 B parameters, 2.59 B active a token;
    deepseek-moe 16.67 B, 2.62 B."""
    q, d = treg.get("qwen3-moe-30b-a3b").full, treg.get("deepseek-moe-16b").full
    assert (q.head_dim, q.n_heads // q.n_kv_heads, d.head_dim, d.n_heads // d.n_kv_heads) == \
        (64, 8, 128, 1)
    for arch in MOE_ARCHS:
        for which in ("full", "reduced"):
            t, j = getattr(treg.get(arch), which), getattr(jreg.get(arch), which)
            assert dataclasses.asdict(t.moe) == dataclasses.asdict(j.moe)
            assert (t.param_count(), t.active_param_count()) == \
                (j.param_count(), j.active_param_count())
    assert q.param_count() == 29_767_960_576 and q.active_param_count() == 2_588_870_656
    assert d.param_count() == 16_669_853_696 and d.active_param_count() == 2_621_032_448
    assert q.remat == d.remat == "full" and q.moe_impl == "einsum"


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_train_steps_match_reference(arch, remat):
    """Three steps of ``lm_loss`` at the REDUCED config (B 4 x S 16: 64
    tokens, C = 32 slots an expert), with and without remat."""
    jcfg = dataclasses.replace(jreg.get(arch).reduced, remat=remat)
    tcfg = dataclasses.replace(treg.get(arch).reduced, remat=remat)
    jp = jT.init_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)

    def batches(step):
        return jpipe.token_batch(0, step, 4, 16, jcfg.vocab)

    ts = run_both((jTS.lm_loss(jcfg), tTS.lm_loss(tcfg), jp, batches))
    assert int(ts.opt.step) == 3


def reference_moe_state(arch, n_steps=2):
    """The reference's REDUCED MoE TrainState after ``n_steps`` steps."""
    cfg = jreg.get(arch).reduced
    params = jT.init_params(jax.random.PRNGKey(1), cfg, dtype=jnp.float32)
    step = jax.jit(jTS.make_train_step(jTS.lm_loss(cfg), jadamw.wsd_schedule(1, 10, 2, 1e-3)))
    state = jTS.init_state(params)
    for s in range(n_steps):
        b = jpipe.token_batch(1, s, 4, 16, cfg.vocab)
        state, _ = step(state, {k: jnp.asarray(v) for k, v in b.items()})
    return state


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_checkpoints_cross_the_packages(arch, tmp_path):
    """A MoE TrainState (router, stacked experts, for deepseek the shared
    experts) written by the reference restores into the port bit for bit,
    and the port's copy of it restores into the reference bit for bit."""
    js = reference_moe_state(arch)
    jckpt.save(str(tmp_path / "ref"), 2, js)
    step, ts = ckpt.restore(str(tmp_path / "ref"), device=CPU, template=port_template(js))
    assert step == 2
    tflat = _tree.flatten_with_paths(ts)
    jpaths, jleaves, _ = jckpt._flatten_with_paths(js)
    assert [p for p, _ in tflat] == jpaths
    assert any("['router']" in p for p in jpaths)
    for (path, t), j in zip(tflat, jleaves):
        assert_bits_equal(t, np.asarray(j), path)
    ckpt.save(str(tmp_path / "port"), 2, ts)
    template = jTS.init_state(jax.tree.map(jnp.zeros_like, js.params))
    step, back = jckpt.restore(str(tmp_path / "port"), template=template)
    assert step == 2
    for (path, t), r in zip(tflat, jax.tree.leaves(back)):
        assert_bits_equal(t, np.asarray(r), path)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_launch_serve_takes_the_moe_archs(arch, capsys):
    tlaunch.main(["--arch", arch, "--reduced", "--device", CPU, "--batch", "2",
                  "--prompt-len", "4", "--max-new", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 7)" in out and "sample:" in out


def test_moe_decode_drops_nothing_at_decode_batch():
    """A decode step's T = B tokens give C = 8 slots an expert, at least
    top_k * B / E of need: at B <= 8 no pair drops, whatever the routing."""
    cfg = treg.get("qwen3-moe-30b-a3b").full
    assert tM._capacity(8, cfg.moe) == 8
    assert tM._capacity(2048, cfg.moe) == 160  # the prefill of 2048 tokens


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (run: python -m pytest -m cuda tests/test_torch_*.py)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_cuda_moe_decode_through_row_12_matches_cpu(cuda, arch):
    """Three REDUCED float32 decode steps on the card through the flash
    kernel (one launch a layer), logits held against the same steps on
    the CPU (plain attention) to rtol 1e-5, atol 1e-5 * max|logits|."""
    assert not torch.backends.cuda.matmul.allow_tf32
    cfg = treg.get(arch).reduced
    cpu_params = tT.init_params(torch.Generator().manual_seed(0), cfg, dtype=torch.float32,
                                device=CPU)
    out = {}
    for dev in (cuda, torch.device(CPU)):
        params = _tree.tree_map(lambda p: p.to(dev), cpu_params)
        cache = tT.init_kv_cache(cfg, 3, 40, dtype=torch.float32, device=dev)
        cache["len"] = torch.tensor([0, 17, 39], dtype=torch.int32, device=dev)
        fd.reset_launches()
        steps = []
        for t in range(3):
            logits, cache = tT.decode_step(params, cfg, cache,
                                           torch.tensor([t, 2 * t, 3 * t], device=dev),
                                           use_flash_kernel=True)
            steps.append(logits.cpu())
        out[dev.type] = (torch.stack(steps), fd.LAUNCHES["flash_decode"])
    assert out["cuda"][1] == 3 * cfg.n_layers and out["cpu"][1] == 0
    scale = float(out["cpu"][0].abs().max())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.cuda
def test_cuda_init_params_peak_is_one_stack_and_one_layer(cuda):
    """``init_params`` on the card allocates each stacked leaf once: its
    peak is the parameters, one layer's tree, and the float32 draw and its
    scaled copy of the largest leaf."""
    cfg = dataclasses.replace(treg.get("qwen3-moe-30b-a3b").reduced, n_layers=8, d_model=256,
                              d_ff=128, moe=tT.MoEFields(n_experts=32, top_k=4))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    params = tT.init_params(torch.Generator(device=cuda).manual_seed(0), cfg, device=cuda)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    leaves = jax.tree.leaves(params)
    total = sum(p.numel() * p.element_size() for p in leaves)
    layer = sum(p[0].numel() * p[0].element_size() for p in jax.tree.leaves(params["layers"]))
    largest = max(p[0].numel() for p in jax.tree.leaves(params["layers"]))
    assert peak <= total + layer + 2 * 4 * largest + (1 << 20), (peak, total, layer)
