"""graphsage-reddit [gnn]: 2 layers, d_hidden=128, mean aggregator,
sample sizes 25-10 [arXiv:1706.02216].  minibatch_lg uses the real
neighbor sampler (data/pipeline.NeighborSampler).

Counterpart of ``repro/configs/graphsage_reddit.py``, same numbers."""
from repro_torch.configs.registry import ArchSpec, GNN_SHAPES, GNNConfig

FULL = GNNConfig(
    name="graphsage-reddit", kind="graphsage", n_layers=2, d_hidden=128,
    aggregator="mean", sample_sizes=(25, 10), n_classes=41,
)
REDUCED = GNNConfig(
    name="graphsage-smoke", kind="graphsage", n_layers=2, d_hidden=16,
    aggregator="mean", sample_sizes=(5, 3), n_classes=7,
)
SPEC = ArchSpec("graphsage-reddit", "gnn", FULL, REDUCED, GNN_SHAPES)
