"""The plain reference of a training step: label assignment, the YOLO loss,
autograd's backward and Adam, written from their definitions.

Labels. A GT row is [x1, y1, x2, y2, class, mixup weight]; rows without
area are padding. Each scale s (stride 8, 16, 32) has A = 3 anchors. A box
is placed at the cell holding its centre on every scale; it takes every
anchor whose IoU with it (both centred there) exceeds ``iou_threshold``,
or, if none does, the one anchor of largest IoU (the first on ties). Where
boxes meet at one cell and anchor the later box wins. A taken cell holds
[box, 1, smoothed one-hot (1 - d at the class, d / C everywhere added),
mixup weight]; every other cell is zero with mixup weight 1. Each scale
also lists, in box order, the boxes it took.

Loss of a scale, summed over cells and averaged over the batch, each cell
weighted by its mixup weight: GIoU loss (1 - GIoU) x (2 - box area / input
area) on taken cells; objectness focal (alpha 0.75, gamma 2) x BCE on taken
cells and on cells whose predicted box overlaps no listed GT box by IoU 0.5
or more; class focal (alpha 0.5, gamma 2) x BCE x 2 on taken cells; each
log clamped at -100.

Adam: b1 0.9, b2 0.999, eps 1e-8, bias-corrected, on every leaf, at the
learning rate of ``lr(k)`` for update k.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from . import net as N


def labels(gt: torch.Tensor, size: int, strides: Sequence[int], anchors, classes: int,
           per_scale: int = 3, iou_threshold: float = 0.3, smooth: float = 0.01):
    """Per scale: the label grid (B, H, W, A, 6 + C) and the box list (B, G, 4)."""
    dev = gt.device
    g = gt.detach().double().cpu()
    anchors = torch.as_tensor(anchors, dtype=torch.float64).reshape(-1, 2)
    b_n, n_g = g.shape[:2]
    grids = [torch.zeros(b_n, size // s, size // s, per_scale, 6 + classes,
                         dtype=torch.float64) for s in strides]
    for grid in grids:
        grid[..., -1] = 1.0
    lists = [torch.zeros(b_n, n_g, 4, dtype=torch.float64) for _ in strides]
    for b in range(b_n):
        filled = [0] * len(strides)
        for j in range(n_g):
            x1, y1, x2, y2, c, mw = g[b, j].tolist()
            if not (x2 > x1 and y2 > y1):
                continue
            cx, cy, w, h = (x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1
            ious = []
            for k, s in enumerate(strides):
                acx, acy = (int(cx // s) + 0.5) * s, (int(cy // s) + 0.5) * s
                for a in range(per_scale):
                    aw, ah = anchors[k * per_scale + a].tolist()
                    iw = max(min(cx + w / 2, acx + aw / 2) - max(cx - w / 2, acx - aw / 2), 0)
                    ih = max(min(cy + h / 2, acy + ah / 2) - max(cy - h / 2, acy - ah / 2), 0)
                    inter = iw * ih
                    ious.append(inter / max(w * h + aw * ah - inter, 1e-12))
            take = [i for i, v in enumerate(ious) if v > iou_threshold]
            if not take:
                take = [max(range(len(ious)), key=lambda i: (ious[i], -i))]
            cls = int(min(max(c, 0), classes - 1))
            onehot = torch.full((classes,), smooth / classes, dtype=torch.float64)
            onehot[cls] += 1.0 - smooth
            entry = torch.cat([torch.tensor([x1, y1, x2, y2, 1.0], dtype=torch.float64),
                               onehot, torch.tensor([mw], dtype=torch.float64)])
            for k, s in enumerate(strides):
                gx, gy = int(cx // s), int(cy // s)
                side = size // s
                if not (0 <= gx < side and 0 <= gy < side):
                    continue
                mine = [i - k * per_scale for i in take if k * per_scale <= i < (k + 1) * per_scale]
                for a in mine:
                    grids[k][b, gy, gx, a] = entry
                if mine:
                    lists[k][b, filled[k]] = torch.tensor([x1, y1, x2, y2], dtype=torch.float64)
                    filled[k] += 1
    return ([t.float().to(dev) for t in grids], [t.float().to(dev) for t in lists])


def _iou_parts(a, b):
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = (rb - lt).clamp_min(0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a + area_b - inter
    return inter, union


def giou(a, b):
    inter, union = _iou_parts(a, b)
    elt = torch.minimum(a[..., :2], b[..., :2])
    erb = torch.maximum(a[..., 2:], b[..., 2:])
    ewh = (erb - elt).clamp_min(0)
    enclose = ewh[..., 0] * ewh[..., 1]
    return inter / union - (enclose - union) / enclose


def bce(p, t):
    return -(t * torch.log(p).clamp_min(-100.0) + (1 - t) * torch.log1p(-p).clamp_min(-100.0))


def focal(t, p, alpha):
    return 2.0 * (t - 1.0 + alpha).abs() * (t - p).abs() ** 2


def scale_loss(pred, label, boxes, stride, classes, ignore_thresh=0.5):
    h, w = pred.shape[1:3]
    area = float(stride * h) * float(stride * w)
    coor, conf, prob = pred[..., :4], pred[..., 4:5], pred[..., 5:]
    lcoor, resp = label[..., :4], label[..., 4:5]
    lprob, mixw = label[..., 5:5 + classes], label[..., -1:]
    lwh = lcoor[..., 2:] - lcoor[..., :2]
    box = resp * (2.0 - lwh[..., 0:1] * lwh[..., 1:2] / area) * (1.0 - giou(coor, lcoor)[..., None])
    with torch.no_grad():
        inter, union = _iou_parts(coor[..., None, :], boxes[:, None, None, None, :, :])
        best = (inter / union).amax(-1, keepdim=True)
    bgd = (1.0 - resp) * (best < ignore_thresh).float()
    cb = bce(conf, resp)
    conf_l = focal(resp, conf, 0.75) * (resp * cb + bgd * cb)
    cls_l = 2.0 * focal(lprob, prob, 0.5) * resp * bce(prob, lprob)

    def red(t):
        return (t * mixw).sum(dim=(1, 2, 3, 4)).mean()
    return red(box) + red(conf_l) + red(cls_l)


def leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    return [tree]


def rebuild(like, flat):
    it = iter(flat)

    def go(t):
        return {k: go(v) for k, v in t.items()} if isinstance(t, dict) else next(it)
    return go(like)


def loss_and_grads(lays, params, state, images_u8, gt, model: Dict, lowp=None):
    """(loss, grads as a list in leaf order, new BN state) of one batch."""
    size = images_u8.shape[1]
    leaf = [t.detach().clone().requires_grad_(True) for t in leaves(params)]
    p = rebuild(params, leaf)
    grids, lists = labels(gt, size, model['strides'], model['anchors'], model['classes'])
    heads, new_state = N.train_forward(lays, p, state, N.normalize(images_u8), lowp)
    loss = 0.0
    for head, l in zip(heads, N.heads_of(lays)):
        k = list(model['strides']).index(l['stride_total'])
        loss = loss + scale_loss(head, grids[k], lists[k], l['stride_total'], l['classes'],
                                 l['ignore_thresh'])
    grads = torch.autograd.grad(loss, leaf, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaf)]
    return loss.detach(), grads, {k: {n: v.detach() for n, v in s.items()}
                                  for k, s in new_state.items()}


class Adam:
    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params):
        self.mu = [torch.zeros_like(t) for t in leaves(params)]
        self.nu = [torch.zeros_like(t) for t in leaves(params)]
        self.count = 0

    def step(self, params, grads, lr):
        self.count += 1
        bc1, bc2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        out = []
        for i, (p, g) in enumerate(zip(leaves(params), grads)):
            self.mu[i] = self.b1 * self.mu[i] + (1 - self.b1) * g
            self.nu[i] = self.b2 * self.nu[i] + (1 - self.b2) * g * g
            out.append(p - lr * (self.mu[i] / bc1) / (torch.sqrt(self.nu[i] / bc2) + self.eps))
        return rebuild(params, out)
