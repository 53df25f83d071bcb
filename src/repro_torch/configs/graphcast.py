"""graphcast [gnn]: encoder-processor-decoder, 16 layers, d_hidden=512,
mesh_refinement=6, sum aggregation, n_vars=227 [arXiv:2212.12794].
On the generic graph shapes the processor runs over the given graph;
``build_multimesh(6)`` gives its own icosahedral multimesh.

Counterpart of ``repro/configs/graphcast.py``, same numbers."""
from repro_torch.configs.registry import ArchSpec, GNN_SHAPES, GNNConfig

FULL = GNNConfig(
    name="graphcast", kind="graphcast", n_layers=16, d_hidden=512,
    aggregator="sum", mesh_refinement=6, n_vars=227, n_classes=227,
)
REDUCED = GNNConfig(
    name="graphcast-smoke", kind="graphcast", n_layers=2, d_hidden=32,
    aggregator="sum", mesh_refinement=1, n_vars=8, n_classes=8,
)
SPEC = ArchSpec("graphcast", "gnn", FULL, REDUCED, GNN_SHAPES)
