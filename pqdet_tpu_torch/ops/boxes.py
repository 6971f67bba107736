"""Box geometry: the IoU family on corner-format (xmin, ymin, xmax, ymax)
boxes, broadcast over leading dims, the last dim the coordinates (the port
of ``pqdet_tpu/ops/boxes.py``: ``iou``, ``giou``, ``diou``, ``ciou``)."""

from __future__ import annotations

import math

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


def _iou_union_enclose(boxes1, boxes2):
    area1, area2 = _areas(boxes1), _areas(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = torch.clamp_min(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    enc_lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    enc_rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    enc_wh = torch.clamp_min(enc_rb - enc_lt, 0.0)
    enclose = enc_wh[..., 0] * enc_wh[..., 1]
    return inter / union, union, enclose, enc_lt, enc_rb


def giou(boxes1, boxes2):
    """Generalised IoU."""
    i, union, enclose, _, _ = _iou_union_enclose(boxes1, boxes2)
    return i - (enclose - union) / enclose


def _center_distance_terms(boxes1, boxes2, enc_lt, enc_rb):
    c1 = (boxes1[..., :2] + boxes1[..., 2:]) / 2
    c2 = (boxes2[..., :2] + boxes2[..., 2:]) / 2
    d_center = torch.sum(torch.square(c1 - c2), dim=-1)
    d_enclose = torch.sum(torch.square(enc_lt - enc_rb), dim=-1)
    return d_center, d_enclose


def diou(boxes1, boxes2):
    """Distance IoU in the JAX package's signed form, GIoU + d_center /
    d_enclose (kept for loss parity)."""
    i, union, enclose, enc_lt, enc_rb = _iou_union_enclose(boxes1, boxes2)
    g = i - (enclose - union) / enclose
    d_center, d_enclose = _center_distance_terms(boxes1, boxes2, enc_lt, enc_rb)
    return g + d_center / d_enclose


def ciou(boxes1, boxes2):
    """Complete IoU; the aspect-ratio weight alpha is a constant (detached).
    ``atan2(w, h)`` equals ``atan(w / h)`` for h > 0 and stays finite on the
    zero-padded label boxes."""
    w1 = boxes1[..., 2] - boxes1[..., 0]
    h1 = boxes1[..., 3] - boxes1[..., 1]
    w2 = boxes2[..., 2] - boxes2[..., 0]
    h2 = boxes2[..., 3] - boxes2[..., 1]
    i, union, enclose, enc_lt, enc_rb = _iou_union_enclose(boxes1, boxes2)
    g = i - (enclose - union) / enclose
    d_center, d_enclose = _center_distance_terms(boxes1, boxes2, enc_lt, enc_rb)
    v = (4.0 / (math.pi ** 2)) * torch.square(torch.atan2(w1, h1) - torch.atan2(w2, h2))
    alpha = (v / (1.0 - i + v)).detach()
    return g + d_center / d_enclose + alpha * v
