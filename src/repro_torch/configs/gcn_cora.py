"""gcn-cora [gnn]: 2 layers, d_hidden=16, mean/symmetric normalization
[arXiv:1609.02907] — the SpMM regime (block-dense kernel).

Counterpart of ``repro/configs/gcn_cora.py``, same numbers."""
from repro_torch.configs.registry import ArchSpec, GNN_SHAPES, GNNConfig

FULL = GNNConfig(
    name="gcn-cora", kind="gcn", n_layers=2, d_hidden=16,
    aggregator="mean", n_classes=7,
)
REDUCED = GNNConfig(
    name="gcn-smoke", kind="gcn", n_layers=2, d_hidden=8,
    aggregator="mean", n_classes=4,
)
SPEC = ArchSpec("gcn-cora", "gnn", FULL, REDUCED, GNN_SHAPES)
