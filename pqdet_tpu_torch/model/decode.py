"""YOLO head decode, plain PyTorch (the port of ``pqdet_tpu/model/decode.py``).

This is the plain version of the Triton decode kernel
(``ops/decode_kernel.py``): the CPU path runs it, and ``chip_smoke.py``
holds the kernel to it on the card. Input is NHWC, the raw head output of
A*(5+C) channels:

    xymin = (grid_center - exp(raw[..., 0:2])) * stride
    xymax = (grid_center + exp(raw[..., 2:4])) * stride
    conf  = sigmoid(raw[..., 4:5])
    prob  = sigmoid(raw[..., 5:])
"""

from __future__ import annotations

import torch


def center_grid(height: int, width: int, device=None):
    """(H, W, 1, 2) grid of cell centres; [..., 0] is x (column), [..., 1]
    is y (row)."""
    ys = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    xs = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing='ij')
    return torch.stack([gx, gy], dim=-1)[:, :, None, :]


def decode(conv: torch.Tensor, num_classes: int, stride: int,
           exp_cap: float = 0.0) -> torch.Tensor:
    """(B, H, W, A*(5+C)) raw head -> (B, H, W, A, 5+C) decoded boxes, f32.

    ``exp_cap`` > 0 clamps the raw box offsets at that value before the
    exp (a NAS survival knob; 0 is a bare exp)."""
    b, h, w, ch = conv.shape
    a = ch // (5 + num_classes)
    conv = conv.reshape(b, h, w, a, 5 + num_classes).float()
    grid = center_grid(h, w, conv.device)
    raw_d1 = conv[..., 0:2]
    raw_d2 = conv[..., 2:4]
    if exp_cap:
        raw_d1 = torch.clamp(raw_d1, max=exp_cap)
        raw_d2 = torch.clamp(raw_d2, max=exp_cap)
    xymin = (grid - torch.exp(raw_d1)) * stride
    xymax = (grid + torch.exp(raw_d2)) * stride
    conf = torch.sigmoid(conv[..., 4:5])
    prob = torch.sigmoid(conv[..., 5:])
    return torch.cat([xymin, xymax, conf, prob], dim=-1)
