"""qwen2.5-3b [dense]: 36L d_model=2048 16H (GQA kv=2) d_ff=11008
vocab=151936 — GQA with QKV bias [hf:Qwen/Qwen2.5; hf].

Counterpart of ``repro/configs/qwen2_5_3b.py``, same numbers."""
from repro_torch.configs.registry import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="qwen2.5-3b", n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab=151936, qkv_bias=True,
)
REDUCED = LMConfig(
    name="qwen2.5-3b-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    d_ff=172, vocab=512, qkv_bias=True,
)
SPEC = ArchSpec("qwen2.5-3b", "lm", FULL, REDUCED, LM_SHAPES)
