"""dcn-v2 [recsys]: 13 dense + 26 sparse(16d), 3 cross layers,
MLP 1024-1024-512 [arXiv:2008.13535].

Counterpart of ``repro/configs/dcn_v2.py``, same numbers."""
from repro_torch.configs.registry import ArchSpec, DCNConfig, RECSYS_SHAPES

FULL = DCNConfig(name="dcn-v2")
REDUCED = DCNConfig(
    name="dcn-v2-smoke", n_dense=4, n_sparse=6, embed_dim=8, n_cross=2,
    mlp_dims=(32, 16), vocab_per_field=1000, n_candidates=512,
)
SPEC = ArchSpec("dcn-v2", "recsys", FULL, REDUCED, RECSYS_SHAPES)
