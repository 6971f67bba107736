"""YOLO label assignment on the device (the port of ``pqdet_tpu/ops/labels.py``).

A training batch carries only its padded raw GT boxes, (B, max_gt, 6); the
per-scale label grids are built from them on the device inside the step,
batched over B:

- the smoothed one-hot, and the IoU of each box against each anchor
  placed at the box's centre cell, in the JAX package's arithmetic, so the
  threshold calls agree bit for bit;
- a box takes every anchor over ``iou_threshold``, or, when none is, the
  anchor of largest IoU (``argmax``: the first on ties);
- at a contended (cell, anchor) slot the last box wins: a scatter-max of
  the box index into a buffer with one extra slot, which takes the dropped
  positions and is sliced off;
- each scale's padded box list keeps box order (cumulative-sum slots).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from pqdet_tpu_torch import resolve_device


def assign_labels_device(gt: torch.Tensor, input_size: Tuple[int, int],
                         strides: Sequence[int], anchors, num_classes: int,
                         gt_per_grid: int = 3, iou_threshold: float = 0.3,
                         deta: float = 0.01):
    """Padded GT boxes -> per-scale label grids and per-scale box lists.

    gt: (B, G, 6) float [x1, y1, x2, y2, class, mixup_weight]; padding rows
    are all zero (boxes without area are masked out). ``strides``: Python
    ints; ``anchors``: (S*A, 2) pixels, a sequence or a tensor (one on gt's
    device is used as it is). Returns a 6-tuple on gt's device: 3
    grids (B, H/s, W/s, A, 6+C), then 3 box lists (B, G, 4), all f32.
    """
    H, W = int(input_size[0]), int(input_size[1])
    dev = gt.device
    f32 = torch.float32
    anchors_f = torch.as_tensor(anchors, dtype=f32, device=dev).reshape(-1, 2)
    S, A, C = len(strides), gt_per_grid, num_classes
    B, G = gt.shape[:2]
    gt = gt.to(f32)

    coor = gt[..., :4]
    valid = (coor[..., 2] > coor[..., 0]) & (coor[..., 3] > coor[..., 1])   # (B, G)
    cls_idx = gt[..., 4].to(torch.int64).clamp(0, C - 1)
    mixw = gt[..., 5]
    cxy = (coor[..., 2:4] + coor[..., :2]) * 0.5                # (B, G, 2)
    wh = coor[..., 2:4] - coor[..., :2]

    onehot = torch.full((B, G, C), deta / C, dtype=f32, device=dev)
    onehot.scatter_add_(2, cls_idx[..., None],
                        torch.full((B, G, 1), 1.0 - deta, dtype=f32, device=dev))

    # per scale, as Python floats: no host-to-device copy per call
    xy_idx = torch.stack([torch.floor(cxy / float(st)) for st in strides],
                         dim=2).to(torch.int64)                         # (B, G, S, 2)
    centers = torch.stack([(xy_idx[:, :, k].to(f32) + 0.5) * float(st)
                           for k, st in enumerate(strides)], dim=2)

    # IoU(box, anchor at the centre cell) of all (G, S*A) pairs
    a_cxy = centers.repeat_interleave(A, dim=2)                         # (B, G, S*A, 2)
    a_wh = anchors_f.expand(B, G, S * A, 2)
    b_min = cxy[:, :, None] - wh[:, :, None] * 0.5
    b_max = cxy[:, :, None] + wh[:, :, None] * 0.5
    a_min = a_cxy - a_wh * 0.5
    a_max = a_cxy + a_wh * 0.5
    inter = torch.prod(torch.clamp_min(torch.minimum(b_max, a_max)
                                       - torch.maximum(b_min, a_min), 0), dim=-1)
    union = (wh[..., 0] * wh[..., 1])[..., None] + a_wh[..., 0] * a_wh[..., 1] - inter
    ious = inter / torch.clamp_min(union, 1e-12)                        # (B, G, S*A)

    mask = ious > iou_threshold
    none_hit = ~mask.any(dim=-1)
    fallback = torch.nn.functional.one_hot(ious.argmax(dim=-1), S * A).bool()
    mask = (mask | (none_hit[..., None] & fallback)) & valid[..., None]

    entries = torch.cat([coor, torch.ones((B, G, 1), dtype=f32, device=dev), onehot,
                         mixw[..., None]], dim=-1)                      # (B, G, 6+C)
    # a background cell is all zero except the mixup-weight channel
    background = torch.zeros(6 + C, dtype=f32, device=dev)
    background[-1] = 1.0

    labels, boxlists = [], []
    gidx = torch.arange(G, device=dev).view(1, G, 1).expand(B, G, A).reshape(B, G * A)
    for s in range(S):
        h, w = H // int(strides[s]), W // int(strides[s])
        x, y = xy_idx[:, :, s, 0], xy_idx[:, :, s, 1]
        inb = (0 <= y) & (y < h) & (0 <= x) & (x < w)
        m = mask[:, :, s * A:(s + 1) * A] & inb[..., None]                # (B, G, A)
        pos = (y * w + x)[..., None] * A + torch.arange(A, device=dev)
        pos = torch.where(m, pos, h * w * A)                              # the drop slot
        winner = torch.full((B, h * w * A + 1), -1, dtype=torch.int64, device=dev)
        winner.scatter_reduce_(1, pos.reshape(B, G * A), gidx, 'amax')
        winner = winner[:, :-1]
        picked = torch.gather(entries, 1, winner.clamp_min(0)[..., None].expand(-1, -1, 6 + C))
        grid = torch.where(winner[..., None] >= 0, picked, background)
        labels.append(grid.reshape(B, h, w, A, 6 + C))

        # the per-scale padded box list, in box order
        hit = m.any(dim=-1)                                               # (B, G)
        slot = torch.where(hit, torch.cumsum(hit.to(torch.int64), dim=1) - 1, G)
        boxes = torch.zeros((B, G + 1, 4), dtype=f32, device=dev)
        boxes.scatter_(1, slot[..., None].expand(-1, -1, 4), coor)
        boxlists.append(boxes[:, :G])
    return tuple(labels) + tuple(boxlists)


def label_assigner_from_config(config, device='cuda'):
    """A (gt, (H, W)) -> targets closure bound to the model's anchors and
    strides (``config.model``) and class count (``config.dataset``), with
    the anchors placed on ``device`` once."""
    dev = resolve_device(device)
    strides = [int(s) for s in config.model.strides]
    anchors = torch.tensor(config.model.anchors, dtype=torch.float32, device=dev)
    nc = len(config.dataset.classes)
    gpg = int(config.model.gt_per_grid)
    thr = float(config.model.anchors_iou_threshold)

    def fn(gt, input_size):
        return assign_labels_device(gt, input_size, strides, anchors, nc,
                                    gt_per_grid=gpg, iou_threshold=thr)
    return fn
