"""The plain float32 reference the benchmark's check holds the port to:
plain PyTorch and NumPy, written from the cfg and the definitions, and
importing nothing of the port or of JAX."""
