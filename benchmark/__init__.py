"""The benchmark of the PyTorch and CUDA port (``pqdet_tpu_torch``): see
``harness.py`` and BENCHMARK.json at the root of the repository."""
