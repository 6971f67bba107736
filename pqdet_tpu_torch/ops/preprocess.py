"""On-device input preprocessing (the port of ``pqdet_tpu/ops/preprocess.py``).

Eval batches ship as uint8 RGB and are ImageNet-normalized on the device
with one folded affine, (x/255 - mean)/std == x*scale + bias in f32. A
float input means the host already normalized and passes through.
"""

from __future__ import annotations

import numpy as np
import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def fold_norm_affine(mean, std):
    """(x/255 - mean)/std == x*scale + bias, with the constants computed in
    numpy f32 exactly as the JAX package computes them."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return ((1.0 / (255.0 * std)).astype(np.float32),
            (-mean / std).astype(np.float32))


NORM_SCALE, NORM_BIAS = fold_norm_affine(IMAGENET_MEAN, IMAGENET_STD)


def device_normalize(images: torch.Tensor) -> torch.Tensor:
    """uint8 (..., 3) images -> ImageNet-normalized float32 on the same
    device; float inputs pass through (already normalized on host)."""
    if images.dtype != torch.uint8:
        return images
    scale = torch.from_numpy(NORM_SCALE).to(images.device)
    bias = torch.from_numpy(NORM_BIAS).to(images.device)
    return images.float() * scale + bias
