"""Plain reference of the benchmark: set semantics of a stream of
publishes, the compressed layout's decode, BFS and PageRank, in plain
PyTorch (on whatever device its tensors are on).  It imports nothing of
the program, and works from the generated inputs alone; the program's
outputs are read only to be judged."""
