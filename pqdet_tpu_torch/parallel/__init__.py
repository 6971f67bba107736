"""Data parallelism: one process per GPU (``parallel/mesh.py``)."""
