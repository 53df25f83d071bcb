"""deepseek-moe-16b [moe]: 28L d_model=2048 16H (kv=16: MHA) d_ff=1408
vocab=102400, 64 routed experts top-6 + 2 shared (fine-grained)
[arXiv:2401.06066].

Counterpart of ``repro/configs/deepseek_moe_16b.py``, same numbers."""
from repro_torch.configs.registry import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import LMConfig, MoEFields

FULL = LMConfig(
    name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1408, vocab=102400,
    moe=MoEFields(n_experts=64, top_k=6, n_shared=2, shared_d_ff=1408),
    remat="full",
)
REDUCED = LMConfig(
    name="deepseek-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=32, vocab=512, moe=MoEFields(n_experts=8, top_k=2, n_shared=1, shared_d_ff=32),
)
SPEC = ArchSpec("deepseek-moe-16b", "lm", FULL, REDUCED, LM_SHAPES)
