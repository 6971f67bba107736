"""YOLO per-scale loss (the port of ``pqdet_tpu/model/loss.py``).

- bbox loss: giou / diou / ciou / iou, or smooth-L1 (beta 1/9);
- confidence loss: focal (alpha 0.75, gamma 2) times BCE, the background
  mask from max-IoU(pred, GT boxes) < ignore_thresh;
- class loss: 2 * focal (alpha 0.5, gamma 2) times BCE;
- everything weighted by the mixup-weight channel, summed over the grid
  and meaned over the batch.

The BCE is written out with each log clamped at -100, as the JAX package
writes it, and not as ``F.binary_cross_entropy``, whose backward divides
by max(p (1 - p), 1e-12) and so differs from it near 0 and 1. GT boxes
come padded to a static length; zero rows have IoU 0 with any prediction,
so they never clear ignore_thresh.
"""

from __future__ import annotations

from typing import Dict

import torch

from pqdet_tpu_torch.ops import boxes as box_ops

BBOX_LOSS_GAIN = 1.0
CONF_LOSS_GAIN = 1.0
CLS_LOSS_GAIN = 2.0
CONF_LOSS_ALPHA = 0.75
CLS_LOSS_ALPHA = 0.5
CONF_LOSS_BETA = 2.0
CLS_LOSS_BETA = 2.0

_BCE_CLAMP = 100.0


def bce(pred, target):
    """Elementwise binary cross entropy on probabilities, each log clamped
    at -100 (log(0) = -inf saturates to the clamp)."""
    log_p = torch.clamp_min(torch.log(pred), -_BCE_CLAMP)
    log_1p = torch.clamp_min(torch.log1p(-pred), -_BCE_CLAMP)
    return -(target * log_p + (1.0 - target) * log_1p)


def focal(target, actual, alpha=0.5, gamma=2.0):
    alpha_t = 2.0 * torch.abs(target - 1.0 + alpha)
    return alpha_t * torch.pow(torch.abs(target - actual), gamma)


def smooth_l1(pred, target, beta=1.0 / 9.0):
    """Smooth-L1 meaned over the last dim (kept)."""
    n = torch.abs(pred - target)
    loss = torch.where(n < beta, 0.5 * n * n / beta, n - 0.5 * beta)
    return torch.mean(loss, dim=-1, keepdim=True)


_IOU_LOSS = {
    'giou': box_ops.giou,
    'diou': box_ops.diou,
    'ciou': box_ops.ciou,
    'iou': box_ops.iou,
}


def loss_per_scale(pred: torch.Tensor, label: torch.Tensor, gt_boxes: torch.Tensor,
                   stride: int, num_classes: int, bbox_loss_type: str = 'giou',
                   ignore_thresh: float = 0.5, l1_loss_gain: float = 0.1,
                   bbox_loss_gain: float = BBOX_LOSS_GAIN,
                   conf_loss_gain: float = CONF_LOSS_GAIN,
                   cls_loss_gain: float = CLS_LOSS_GAIN,
                   conf_loss_alpha: float = CONF_LOSS_ALPHA,
                   cls_loss_alpha: float = CLS_LOSS_ALPHA,
                   conf_loss_beta: float = CONF_LOSS_BETA,
                   cls_loss_beta: float = CLS_LOSS_BETA):
    """(loss, bbox_loss, conf_loss, prob_loss) of one scale, each of shape (1,).

    pred:     (B, H, W, A, 5+C) decoded predictions
    label:    (B, H, W, A, 6+C) [x1 y1 x2 y2, objectness, C smoothed one-hot,
              mixup weight]
    gt_boxes: (B, N, 4) zero-padded raw GT corner boxes of this scale
    """
    pred = pred.float()
    label = label.float()
    gt_boxes = gt_boxes.float()

    h, w = pred.shape[1:3]
    in_area = float(stride * h) * float(stride * w)

    pred_coor = pred[..., 0:4]
    pred_conf = pred[..., 4:5]
    pred_prob = pred[..., 5:]

    label_coor = label[..., 0:4]
    respond_bbox = label[..., 4:5]
    label_prob = label[..., 5:5 + num_classes]
    label_mixw = label[..., -1:]

    bbox_wh = label_coor[..., 2:] - label_coor[..., :2]
    bbox_loss_scale = 2.0 - bbox_wh[..., 0:1] * bbox_wh[..., 1:2] / in_area

    if bbox_loss_type == 'l1':
        bbox_loss = respond_bbox * bbox_loss_scale * \
            smooth_l1(pred_coor, label_coor) * l1_loss_gain
    elif bbox_loss_type in _IOU_LOSS:
        quality = _IOU_LOSS[bbox_loss_type](pred_coor, label_coor)[..., None]
        bbox_loss = respond_bbox * bbox_loss_scale * (1.0 - quality)
    else:
        raise NotImplementedError(bbox_loss_type)
    bbox_loss = bbox_loss * bbox_loss_gain

    # background mask: anchors whose best IoU against any GT box is below
    # ignore_thresh. The (B, H, W, A, N) IoU only feeds a comparison: it is
    # taken without autograd, so none of it is kept for the backward pass
    with torch.no_grad():
        pair_iou = box_ops.iou(pred_coor.detach()[:, :, :, :, None, :],
                               gt_boxes[:, None, None, None, :, :])
        max_iou = torch.amax(pair_iou, dim=-1)[..., None]
        del pair_iou
    respond_bgd = (1.0 - respond_bbox) * (max_iou < ignore_thresh).float()

    conf_focal = focal(respond_bbox, pred_conf, alpha=conf_loss_alpha, gamma=conf_loss_beta)
    conf_bce = bce(pred_conf, respond_bbox)
    conf_loss = conf_loss_gain * conf_focal * (
        respond_bbox * conf_bce + respond_bgd * conf_bce)

    class_focal = focal(label_prob, pred_prob, alpha=cls_loss_alpha, gamma=cls_loss_beta)
    prob_loss = cls_loss_gain * class_focal * respond_bbox * bce(pred_prob, label_prob)

    def _reduce(x):
        return torch.mean(torch.sum(x * label_mixw, dim=(1, 2, 3, 4)), dim=0, keepdim=True)

    bbox_loss = _reduce(bbox_loss)
    conf_loss = _reduce(conf_loss)
    prob_loss = _reduce(prob_loss)
    total = bbox_loss + conf_loss + prob_loss
    return total, bbox_loss, conf_loss, prob_loss


def sum_scale_losses(per_scale) -> Dict[str, torch.Tensor]:
    """Per-head loss 4-tuples -> the loss dict: totals over the heads of
    each part, and each head's total as ``loss_per_branch``."""
    totals = [sum(parts) for parts in zip(*per_scale)]
    per_branch = [ls[1] + ls[2] + ls[3] for ls in per_scale]
    return {
        'loss': totals[0],
        'giou_loss': totals[1],
        'conf_loss': totals[2],
        'class_loss': totals[3],
        'loss_per_branch': per_branch,
    }
