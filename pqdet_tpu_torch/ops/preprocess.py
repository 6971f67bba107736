"""On-device input preprocessing (the port of ``pqdet_tpu/ops/preprocess.py``).

Eval batches ship as uint8 RGB and are ImageNet-normalized on the device
with one folded affine, (x/255 - mean)/std == x*scale + bias in f32. A
float input means the host already normalized and passes through.
"""

from __future__ import annotations

import torch

# the folded affine lives with the host chain (as in the JAX package), so
# the loader's workers build batches without importing torch
from pqdet_tpu_torch.data.augment import (IMAGENET_MEAN, IMAGENET_STD,  # noqa: F401
                                          NORM_BIAS, NORM_SCALE, fold_norm_affine)


def device_normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 (..., 3) images -> ImageNet-normalized float32 on the same
    device; float inputs pass through (already normalized on host)."""
    if images.dtype != torch.uint8:
        return images
    scale = torch.from_numpy(NORM_SCALE).to(images.device)
    bias = torch.from_numpy(NORM_BIAS).to(images.device)
    return images.float() * scale + bias
