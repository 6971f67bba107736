"""On-device post-processing: box recovery + fixed-shape batched NMS.

The port of ``pqdet_tpu/ops/postprocess.py``. Recovery is vectorised over
the batch; NMS selects a static top-K candidate pool per image and runs
greedy class-offset suppression as a fixed point over an IoU matrix. The
JAX package ``vmap``s one image; here the batch dimension is written out,
and ``nms_single`` is the batch of one.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pqdet_tpu_torch.ops.boxes import iou
from pqdet_tpu_torch.utils import tracing


# ----------------------------------------------------------------- recovery

def letterbox_affine(input_size, original_size):
    """Inverse-affine parameters for letterbox-resized inputs. Returns
    (delta (B, 2) in (h, w) order, ratio (B, 1))."""
    ratio = torch.min(input_size / original_size, dim=-1, keepdim=True).values
    delta = torch.floor((input_size - torch.round(ratio * original_size)) / 2)
    return delta, ratio


def ratio_pad_affine(input_size, original_size, resize_ratio: float = 1.25,
                     divisor: int = 32):
    """Inverse-affine for ResizeRatio + PadNearestDivisor eval inputs
    (VisDrone); mirrors the forward ops exactly (round half to even,
    floor-div padding split)."""
    resized = torch.round(resize_ratio * original_size)
    padded = torch.ceil(resized / divisor) * divisor
    delta = torch.floor((padded - resized) / 2)
    ratio = torch.full(original_size.shape[:-1] + (1,), resize_ratio,
                       dtype=original_size.dtype, device=original_size.device)
    return delta, ratio


def recover_bboxes(pred, input_size, original_size, affine=letterbox_affine):
    """(B, N, 5+C) decoded preds -> (B, N, 4+C) original-image boxes with
    conf folded into the class scores.

    input_size: (2,) model input (h, w); original_size: (B, 2) image (h, w).
    """
    coor = pred[..., 0:4]
    conf = pred[..., 4:5]
    prob = pred[..., 5:]

    delta, ratio = affine(input_size, original_size)
    # delta is (h, w): x coords subtract delta[..., 1], y subtract delta[..., 0]
    delta_xyxy = delta[..., [1, 0, 1, 0]][..., None, :]
    coor = (coor - delta_xyxy) / ratio[..., None, :]

    max_xy = (original_size - 1.0)[..., [1, 0]][..., None, :]
    xymin = torch.clamp_min(coor[..., :2], 0.0)
    xymax = torch.minimum(coor[..., 2:], max_xy)
    scores = prob * conf
    return torch.cat([xymin, xymax, scores], dim=-1)


# ---------------------------------------------------------------------- NMS

class NMSResult(NamedTuple):
    boxes: torch.Tensor    # (..., K, 4) original-image coordinates
    scores: torch.Tensor   # (..., K)
    classes: torch.Tensor  # (..., K) int32
    valid: torch.Tensor    # (..., K) bool: kept and above threshold
    overflow: torch.Tensor  # (...) bool: pool clipped above-threshold candidates


def _take(t, idx):
    """t[b, idx[b, j], ...] for a (B, K, ...) tensor and (B, M) indices."""
    idx = idx.reshape(idx.shape + (1,) * (t.dim() - 2))
    return torch.gather(t, 1, idx.expand(idx.shape[:2] + t.shape[2:]))


def nms_batch(boxes_scores: torch.Tensor, score_threshold: float,
              iou_threshold: float, max_outputs: int = 256,
              pool_factor: int = 4, method: str = 'nms',
              sigma: float = 0.3) -> NMSResult:
    """Greedy class-offset NMS per image, fixed output size:
    (B, N, 4+C) -> NMSResult with leading B.

    Every (box, class) pair with score > threshold is a candidate.
    Suppression runs over a pool of the ``max_outputs * pool_factor``
    top-scored pairs; the kept ones are compacted, score-ordered, into
    the fixed-size output. ``overflow`` says that more pairs than the pool
    cleared the threshold. ``method='soft-nms'`` is Gaussian soft-NMS.
    """
    boxes = boxes_scores[..., :4]
    scores = boxes_scores[..., 4:]
    b, n, c = scores.shape
    k = min(max(max_outputs * pool_factor, max_outputs), n * c)

    flat = scores.reshape(b, n * c)
    top_scores, top_idx = torch.topk(flat, k, dim=1)
    box_idx = top_idx // c
    classes = (top_idx % c).to(torch.int32)
    cand = _take(boxes, box_idx)
    valid = top_scores > score_threshold
    overflow = (flat > score_threshold).sum(dim=1) > k

    if method == 'soft-nms':
        return _soft_nms_pool(cand, classes, top_scores, valid, overflow,
                              score_threshold, sigma, max_outputs, k)
    if method != 'nms':
        raise ValueError(f'unknown NMS method {method!r}')

    # separate classes by shifting boxes with a data-dependent offset
    span = boxes.amax(dim=(1, 2)) + 1.0
    shifted = cand + (classes.to(cand.dtype) * span[:, None])[..., None]
    iou_mat = iou(shifted[:, :, None, :], shifted[:, None, :, :])  # (B, k, k)

    # j suppresses i when j has the higher rank (j < i) and IoU > threshold
    order = torch.arange(k, device=boxes.device)
    sup = (iou_mat > iou_threshold) & (order[:, None] < order[None, :])

    keep = _greedy_fixed_point(valid, sup, k)

    # compact the kept candidates (already score-descending) into the
    # fixed output size: a stable sort on ~keep moves kept rows first
    m = min(max_outputs, k)
    sel = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)[:, :m]
    return NMSResult(_take(cand, sel), _take(top_scores, sel),
                     _take(classes, sel), _take(keep, sel), overflow)


def _greedy_fixed_point(valid, sup, k: int):
    """Exact greedy NMS as a fixed point: keep[i] = valid[i] and no KEPT
    higher-ranked j suppresses i. From keep = valid it converges in
    O(longest suppression chain) steps; a converged image stays put.

    Eagerly the loop reads its condition on the host, each read counted in
    ``nms.rounds`` (``utils/tracing.py``). ``torch.export``
    cannot trace that read, so under export the same steps run in a
    ``while_loop`` over an (it, prev, keep) carry, bounded by ``k`` as the
    eager loop is."""
    def step(keep):
        return valid & ~(sup & keep[:, :, None]).any(dim=1)

    if torch.compiler.is_exporting():
        from torch._higher_order_ops import while_loop

        def cond(it, prev, keep):
            return (it < k) & (keep != prev).any()

        def body(it, prev, keep):
            return it + 1, keep.clone(), step(keep)

        it0 = torch.zeros((), dtype=torch.int64, device=valid.device)
        return while_loop(cond, body, (it0, valid.clone(), step(valid)))[2]
    prev, keep, it = valid, step(valid), 0
    while it < k and bool((keep != prev).any()):
        prev, keep, it = keep, step(keep), it + 1
    tracing.count('nms.rounds', min(it + 1, k))
    return keep


def _soft_nms_pool(cand, classes, top_scores, valid, overflow,
                   score_threshold, sigma, max_outputs, k):
    """Fixed-shape Gaussian soft-NMS over the candidate pool: pick the
    highest live score, decay every other same-class candidate by
    exp(-iou^2/sigma), drop those below the threshold, repeat."""
    b = cand.shape[0]
    iou_mat = iou(cand[:, :, None, :], cand[:, None, :, :])          # (B, k, k)
    same = classes[:, :, None] == classes[:, None, :]
    decay = torch.where(same, torch.exp(-(iou_mat ** 2) / sigma),
                        torch.ones_like(iou_mat))
    m = min(max_outputs, k)
    rows = torch.arange(b, device=cand.device)
    cols = torch.arange(k, device=cand.device)

    cur = top_scores
    picked = torch.zeros_like(valid)
    pick_scores = torch.zeros_like(top_scores)
    pick_rank = torch.full_like(classes, k)
    neg_inf = torch.tensor(float('-inf'), device=cand.device, dtype=cur.dtype)
    for t in range(m):
        alive = valid & ~picked & (cur > score_threshold)
        i = torch.argmax(torch.where(alive, cur, neg_inf), dim=1)
        has = alive.any(dim=1)
        onehot = (cols[None, :] == i[:, None]) & has[:, None]
        picked = picked | onehot
        pick_scores = torch.where(onehot, cur, pick_scores)
        pick_rank = torch.where(onehot, torch.full_like(pick_rank, t), pick_rank)
        # decay un-picked same-class candidates by the picked row's weights
        cur = torch.where(has[:, None] & ~picked, cur * decay[rows, i], cur)

    sel = torch.argsort(pick_rank, dim=1, stable=True)[:, :m]
    return NMSResult(_take(cand, sel), _take(pick_scores, sel),
                     _take(classes, sel), _take(picked, sel), overflow)


def nms_single(boxes_scores: torch.Tensor, score_threshold: float,
               iou_threshold: float, max_outputs: int = 256,
               pool_factor: int = 4, method: str = 'nms',
               sigma: float = 0.3) -> NMSResult:
    """NMS for one image: (N, 4+C) -> NMSResult (see ``nms_batch``)."""
    res = nms_batch(boxes_scores[None], score_threshold, iou_threshold,
                    max_outputs, pool_factor, method, sigma)
    return NMSResult(*(t[0] for t in res))


def nms_to_numpy(result: NMSResult):
    """One image's NMSResult -> (M, 6) ndarray [x1, y1, x2, y2, score,
    class] of its valid rows (host side)."""
    import numpy as np
    keep = np.asarray(result.valid)
    return np.concatenate([
        np.asarray(result.boxes)[keep],
        np.asarray(result.scores)[keep, None],
        np.asarray(result.classes)[keep, None].astype(np.float32),
    ], axis=1)
