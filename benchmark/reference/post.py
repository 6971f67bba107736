"""The plain reference of serving's post-processing: letterbox recovery of
the boxes and greedy per-class NMS, written from their definitions.

Letterbox: an (h, w) image was scaled by r = min(S / h, S / w) into an S x S
input and centred, its offset floor((S - round(r * side)) / 2) on each
axis. A box goes back by subtracting the offset and dividing by r; its
top-left is clipped at 0 and its bottom-right at (w - 1, h - 1). A pair's
score is objectness x class probability.

NMS (``eval.nms_method nms``): the ``max_detections * pool_factor``
best-scored (box, class) pairs form the pool; going down it by score, a
pair scoring above ``score_threshold`` is kept unless a kept pair of its
class overlaps it by IoU above ``iou_threshold``; the first
``max_detections`` kept are the answer, best first.
"""

from __future__ import annotations

import numpy as np
import torch


def recover(preds: torch.Tensor, size: int, shapes: torch.Tensor):
    """(B, N, 5 + C) preds at an S x S input, (B, 2) original (h, w) ->
    (boxes (B, N, 4), scores (B, N, C)) in original pixels."""
    hw = shapes.to(preds.device).float()
    r = torch.min(size / hw, dim=1, keepdim=True).values                    # (B, 1)
    off = torch.floor((size - torch.round(r * hw)) / 2)                     # (B, 2) (h, w)
    off_xyxy = off[:, [1, 0, 1, 0]][:, None, :]
    boxes = (preds[..., :4] - off_xyxy) / r[:, :, None]
    hi = (hw - 1)[:, [1, 0]][:, None, :]
    boxes = torch.cat([boxes[..., :2].clamp_min(0.0), torch.minimum(boxes[..., 2:], hi)], -1)
    return boxes, preds[..., 5:] * preds[..., 4:5]


def iou_matrix(a, b):
    """IoU of every box of ``a`` (..., n, 4) with every box of ``b`` (..., m, 4),
    float64; numpy arrays or tensors."""
    lib = torch if isinstance(a, torch.Tensor) else np
    a = a.double() if lib is torch else a.astype(np.float64)
    b = b.double() if lib is torch else b.astype(np.float64)
    lt = lib.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = lib.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = rb - lt
    wh = wh.clamp_min(0) if lib is torch else np.clip(wh, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    pos = union > 0
    return lib.where(pos, inter / lib.where(pos, union, lib.ones_like(union)), 0 * inter)


def nms(boxes: torch.Tensor, scores: torch.Tensor, score_threshold: float,
        iou_threshold: float, max_detections: int, pool_factor: int):
    """A block of images' (B, N, 4) boxes and (B, N, C) scores -> per image
    an (M, 6) [x1 y1 x2 y2 score class] array of the kept pairs, best first."""
    b, n, c = scores.shape
    k = min(max_detections * pool_factor, n * c)
    top, idx = torch.topk(scores.reshape(b, -1), k, dim=1)
    cand = torch.gather(boxes, 1, (idx // c)[..., None].expand(b, k, 4))
    cls = idx % c
    over = (iou_matrix(cand, cand) > iou_threshold) & (cls[:, :, None] == cls[:, None, :])
    over, top, cand, cls = (t.cpu().numpy() for t in (over, top, cand, cls))
    out = []
    for j in range(b):
        kept = []
        dead = np.zeros(k, bool)
        for i in range(k):
            if dead[i] or not top[j, i] > score_threshold:
                continue
            kept.append(i)
            if len(kept) == max_detections:
                break
            dead |= over[j, i]
        kept = np.asarray(kept, np.int64)
        out.append(np.concatenate([cand[j, kept], top[j, kept, None],
                                   cls[j, kept, None].astype(np.float32)], 1).astype(np.float32))
    return out
