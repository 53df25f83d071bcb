"""starcoder2-7b [dense]: 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152 — GQA, RoPE, a 2-matrix tanh-GELU MLP [arXiv:2402.19173].

Counterpart of ``repro/configs/starcoder2_7b.py``, same numbers."""
from repro_torch.configs.registry import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="starcoder2-7b", n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab=49152, mlp_kind="gelu",
)
REDUCED = LMConfig(
    name="starcoder2-7b-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=512, vocab=512, mlp_kind="gelu",
)
SPEC = ArchSpec("starcoder2-7b", "lm", FULL, REDUCED, LM_SHAPES)
