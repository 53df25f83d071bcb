"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768
(per expert) vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B].

Counterpart of ``repro/configs/qwen3_moe_30b_a3b.py``, same numbers."""
from repro_torch.configs.registry import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import LMConfig, MoEFields

FULL = LMConfig(
    name="qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32,
    n_kv_heads=4, d_ff=768, vocab=151936,
    moe=MoEFields(n_experts=128, top_k=8),
    remat="full",
)
REDUCED = LMConfig(
    name="qwen3-moe-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=32, vocab=512, moe=MoEFields(n_experts=8, top_k=2),
)
SPEC = ArchSpec("qwen3-moe-30b-a3b", "lm", FULL, REDUCED, LM_SHAPES)
