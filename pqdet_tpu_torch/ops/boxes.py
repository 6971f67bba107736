"""Box geometry: plain IoU on corner-format (xmin, ymin, xmax, ymax) boxes,
broadcast over leading dims (the port of ``pqdet_tpu/ops/boxes.py::iou``;
GIoU, DIoU and CIoU come with the training slice)."""

from __future__ import annotations

import torch


def _areas(boxes):
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def iou(boxes1, boxes2):
    """Plain IoU. Degenerate overlap yields 0; the division is unguarded,
    as in the JAX package."""
    area1, area2 = _areas(boxes1), _areas(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    return inter / union
