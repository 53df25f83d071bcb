"""schnet [gnn]: 3 interactions, d_hidden=64, 300 RBF, cutoff=10
[arXiv:1706.08566] — continuous-filter conv; edges carry distances.

Counterpart of ``repro/configs/schnet.py``, same numbers."""
from repro_torch.configs.registry import ArchSpec, GNN_SHAPES, GNNConfig

FULL = GNNConfig(
    name="schnet", kind="schnet", n_layers=3, d_hidden=64,
    aggregator="sum", n_rbf=300, cutoff=10.0, n_classes=1,
)
REDUCED = GNNConfig(
    name="schnet-smoke", kind="schnet", n_layers=2, d_hidden=16,
    aggregator="sum", n_rbf=20, cutoff=10.0, n_classes=1,
)
SPEC = ArchSpec("schnet", "gnn", FULL, REDUCED, GNN_SHAPES)
