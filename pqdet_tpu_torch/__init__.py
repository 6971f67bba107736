"""pqdet_tpu_torch — the PyTorch and CUDA port of pqdet_tpu for NVIDIA Hopper.

A second package beside ``pqdet_tpu`` (the JAX reference, which it never
imports). This slice serves the detector: darknet ``.cfg`` -> graph IR ->
layer walk with hand-written Hopper kernels (the fused inverted-residual
conv in CUDA C++, the YOLO head decode in Triton) -> box recovery -> NMS.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); on the CPU every kernel wrapper runs its plain PyTorch
version, because the tensor it was given lies on the CPU.
"""

from __future__ import annotations

__version__ = "0.1.0"


def resolve_device(device="cuda"):
    """``device`` as a ``torch.device``; raises when CUDA is asked for and
    this machine has none (there is no silent CPU fallback). torch is
    imported here, not with the package: the host loader's worker
    processes import the data modules without it."""
    import torch
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            f'device={str(device)!r} was asked for but torch.cuda.is_available()'
            ' is False; pass device="cpu" to run the plain PyTorch versions')
    return dev
