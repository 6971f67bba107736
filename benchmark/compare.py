"""The numbers that decide ``correct``: what the timed path produced against
the plain reference.

Serving, per image of the sampled requests, with the reference's recovered
candidates (every box and class score) and its NMS answer:

- ``score_gap`` and ``box_gap_px``: each served detection is matched to the
  reference candidate of its class nearest to it, the distance being the
  larger of the box's widest coordinate gap in input pixels and the score
  gap in hundredths; the two gaps of that match, the widest over the
  sample;
- ``top_gap``: the image's best served score against the reference's
  best kept score (0 where nothing is served), the widest gap over the
  sample. The best candidate is always kept, whatever NMS does with near
  ties below it, so the number sees a missing answer and the score error
  of the best detection alone;
- ``profile_gap``: the served scores best first against the reference's
  kept scores best first, over the first ``ranks`` ranks, a missing row
  reading 0; the mean gap over those ranks and the sampled images. It is
  worked out and not compared: sorting dilutes a lower precision's score
  errors, and a near tie that NMS breaks the other way changes which
  chain of boxes it suppresses, so no limit holds between the program and
  the control (PERF.md);
- ``nms_iou``: the largest IoU of two served detections of one class. The
  configuration's ``eval.iou_threshold`` bounds it.

Training, over the first three steps, against the reference's three; the
leaves whose reference gradient is under a thousandth of the median leaf's
(``quiet_leaves``: they move by round-off alone) are left out but where
said:

- ``loss_gap``: the widest relative gap of a step's loss. It sees an update
  that moves nothing or moves the wrong way;
- ``grad_gap``: the first gradient, as the optimizer got it, leaf by leaf:
  the gap of the two norms over the larger of the reference's norm of that
  leaf and of the median leaf; the median leaf's gap. (The worst leaf's,
  ``grad_gap_worst``, and the same over every leaf, ``grad_gap_all``, read
  the rounding noise of BN leaves whose true gradient nearly cancels; they
  are worked out and not compared: PERF.md gives the readings);
- ``change_gap``: the same for each parameter's and BN statistic's change
  over the three steps; the worst leaf;
- ``bn_gap``: each BN running statistic's change over the first step (the
  batch's moments of every layer, before any parameter moved): the norm of
  the two changes' difference over the norm of the reference's; the median
  leaf's.

``change_dir`` and ``change_dir_worst``, each leaf's change as a norm of
the difference, are worked out and not compared: Adam's first updates are
near the sign of each gradient element, which bf16 rounding flips, so sound
runs read about 1.1 and an update of the wrong sign 1.4 (PERF.md).
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

from .reference.post import iou_matrix

SCORE_UNIT = 0.01      # a score gap of this much weighs as one input pixel


def serve_image(served: np.ndarray, boxes: torch.Tensor, scores: torch.Tensor,
                kept: np.ndarray, ratio: float, ranks: int) -> Dict[str, float]:
    out = {'score_gap': 0.0, 'box_gap_px': 0.0}
    if len(served):
        d = torch.as_tensor(served, device=boxes.device, dtype=torch.float32)
        cls = d[:, 5].long().clamp(0, scores.shape[1] - 1)
        box = (d[:, None, :4] - boxes[None]).abs().amax(-1) * ratio            # (M, N)
        sc = (d[:, 4:5] - scores[:, cls].T).abs()                              # (M, N)
        best = torch.maximum(box, sc / SCORE_UNIT).argmin(1)
        rows = torch.arange(len(d), device=boxes.device)
        out['box_gap_px'] = float(box[rows, best].max())
        out['score_gap'] = float(sc[rows, best].max())
    a = np.zeros(ranks)
    b = np.zeros(ranks)
    top = np.sort(served[:, 4])[::-1][:ranks]
    a[:len(top)] = top
    b[:min(len(kept), ranks)] = kept[:ranks, 4]
    out['profile_gap'] = float(np.abs(a - b).mean())
    out['top_gap'] = abs((float(served[:, 4].max()) if len(served) else 0.0)
                         - (float(kept[:, 4].max()) if len(kept) else 0.0))
    over = 0.0
    if len(served) > 1:
        iou = iou_matrix(served[:, :4], served[:, :4])
        same = served[:, 5][:, None] == served[:, 5][None, :]
        iou = np.where(same & ~np.eye(len(served), dtype=bool), iou, 0.0)
        over = float(iou.max())
    out['nms_iou'] = over
    return out


MEAN_OVER_IMAGES = ('profile_gap',)


def worst(rows: List[Dict[str, float]]) -> Dict[str, float]:
    """Each number over the images: the widest, or the mean for those of
    ``MEAN_OVER_IMAGES``."""
    return {k: (statistics.fmean if k in MEAN_OVER_IMAGES else max)([r[k] for r in rows])
            for k in rows[0]}


def leaf_gaps(prog: List[torch.Tensor], ref: List[torch.Tensor], skip=()) -> List[float]:
    """Each leaf's |norm(prog) - norm(ref)| / max(norm(ref), median ref
    norm), but those in ``skip``."""
    pn = [float(torch.linalg.vector_norm(t.double())) for t in prog]
    rn = [float(torch.linalg.vector_norm(t.double())) for t in ref]
    med = statistics.median(rn)
    return [abs(p - r) / max(r, med, 1e-30) for i, (p, r) in enumerate(zip(pn, rn))
            if i not in skip]


def state_gaps(prog: List[torch.Tensor], ref: List[torch.Tensor],
               start: List[torch.Tensor]) -> List[float]:
    """Each leaf's |(prog - start) - (ref - start)| / |ref - start|."""
    return [float(torch.linalg.vector_norm((p - r).double())
                  / torch.linalg.vector_norm((r - s).double()).clamp_min(1e-30))
            for p, r, s in zip(prog, ref, start)]


def quiet_leaves(grads: List[torch.Tensor], share: float = 1e-3) -> set:
    """Indices of the leaves whose gradient norm is under ``share`` of the
    median leaf's."""
    n = [float(torch.linalg.vector_norm(g.double())) for g in grads]
    med = statistics.median(n)
    return {i for i, v in enumerate(n) if v < share * med}


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {'value', 'limit'}}): correct when every number is
    at or under its limit (a NaN is not)."""
    table = {k: {'value': numbers[k], 'limit': limits[k]} for k in limits}
    ok = all(v['value'] <= v['limit'] for v in table.values())
    return ok, table
