"""The benchmark of the PyTorch/CUDA port: one cell of ``BENCHMARK.json``
a run (``python -m benchmark --workload ... --seed ... --seconds ...
--trace 0|1``; see ``README.md``).  It imports nothing of JAX or of the
JAX package; ``reference/`` imports nothing of the port either."""
