"""Benchmark of the PyTorch and CUDA port (``repro_torch``): one cell a run.

Run from the repository root: ``python3 -m bench.run --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``.  See ``bench/README.md``."""
