"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.

llama-arch small [hf:HuggingFaceTB/SmolLM; hf].

Counterpart of ``repro/configs/smollm_360m.py``, same numbers."""
from repro_torch.configs.registry import ArchSpec, LM_SHAPES
from repro_torch.models.transformer import LMConfig

FULL = LMConfig(
    name="smollm-360m", n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152,
)
REDUCED = LMConfig(
    name="smollm-360m-smoke", n_layers=2, d_model=64, n_heads=5, n_kv_heads=5,
    d_ff=160, vocab=512,
)
SPEC = ArchSpec("smollm-360m", "lm", FULL, REDUCED, LM_SHAPES)
