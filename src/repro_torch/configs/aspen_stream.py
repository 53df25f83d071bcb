"""aspen-stream [stream]: the paper's own configuration — the Aspen
streaming step (flat C-tree batch union + offsets rebuild) and global
queries (BFS/CC edgeMap steps) at production scale.

Counterpart of ``repro/configs/aspen_stream.py``, same numbers: ``b`` is
the C-tree's expected chunk size, ``seed`` its head hash's."""
from repro_torch.configs.registry import ArchSpec, STREAM_SHAPES, StreamConfig

FULL = StreamConfig(name="aspen-stream", b=256)
REDUCED = StreamConfig(name="aspen-stream-smoke", b=8)
SPEC = ArchSpec("aspen-stream", "stream", FULL, REDUCED, STREAM_SHAPES)
