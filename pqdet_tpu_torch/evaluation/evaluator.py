"""Streaming cocoeval-style AP evaluator (the port of
``pqdet_tpu/evaluation/evaluator.py``, same matching semantics):

- detections per class are processed in descending score, ties broken by
  insertion order
- per-file per-class GT is sorted easy-first (stable), `seen` flags are per
  IoU threshold, and gt_count counts only non-difficult boxes
- the greedy match scans GT in easy-first order, skipping already-seen
  boxes, stopping early when a pick exists and the difficult region starts
- when no GT is picked, the difficult flag of the LAST sorted GT (index
  -1) decides: an unmatched detection is dropped (neither TP nor FP)
  whenever the file/class has any difficult GT
- IoU uses the VOC +1 pixel convention
- AP = precision-envelope integration over recall deltas, 10 IoU
  thresholds 0.50:0.05:0.95

The matcher is the native one (``native/ap_matcher.cpp``); the Python
matcher is its plain version, run when the caller asks (``native=False``).
``evaluate`` calls its ``predict`` under ``torch.inference_mode()``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Sequence

import numpy as np
import torch

from pqdet_tpu_torch.native import matcher as native_matcher

AP_IOU_THRESHOLDS = np.linspace(0.5, 0.95, 10)


class APResult(NamedTuple):
    mAPs: np.ndarray          # (10,) mean AP per IoU threshold
    APs: np.ndarray           # (C,) mean AP per class
    AP: float                 # scalar mean
    raw: np.ndarray           # (C, 10)
    class_names: Sequence[str]
    iou_thresholds: np.ndarray


class _ClassLabel(NamedTuple):
    bboxes: np.ndarray     # (N, 4), sorted easy-first
    seen: np.ndarray       # (10, N) bool, mutated during matching
    difficult: np.ndarray  # (N,) bool, sorted easy-first


def format_ap_table(metric: APResult, verbose: bool = True) -> str:
    """Pretty AP table."""
    def fmt(fs):
        return ['{:.2f}'.format(f * 100) for f in fs]

    rows = []
    if verbose:
        head = 'CLASS\\IOU'
        col1 = max(len(head), max(len(n) for n in metric.class_names)) + 2
        names = metric.class_names
    else:
        head, col1, names = 'IOU', 6, []
    widths = [col1] + [7] * len(metric.iou_thresholds) + [5]
    rows.append([head] + [str(int(round(t * 100))) for t in metric.iou_thresholds] + ['APs'])
    for i, name in enumerate(names):
        rows.append([name] + fmt(list(metric.raw[i]) + [metric.APs[i]]))
    rows.append(['mAPs'] + fmt(list(metric.mAPs) + [metric.AP]))
    return '\n'.join(
        ''.join(str(e).ljust(w) for w, e in zip(widths, r)) for r in rows)


class Evaluator:
    """Accumulates detections + labels, computes AP over 10 IoU thresholds.

    ``predict`` maps a preprocessed image batch (B, H, W, 3) to a list of
    per-image (M, 6) numpy arrays [x1, y1, x2, y2, score, class] — i.e. the
    full forward + recover + NMS pipeline (wired by the trainer / CLI).
    """

    def __init__(self, predict: Callable, dataset, config, native: bool = True):
        self._classes = list(config.dataset.classes)
        self.predict = predict
        self.dataset = dataset
        self._num_workers = config.system.num_workers
        self._prefetch = config.system.prefetch
        self._native = native
        self.reset()

    def reset(self):
        # class -> list of (insertion_idx, file_name, bbox(6,))
        self._detections: Dict[int, List] = defaultdict(list)
        self._labels: Dict[str, Dict[int, _ClassLabel]] = defaultdict(dict)
        self._gt_count: Dict[int, int] = defaultdict(int)
        self._insert_idx = 0

    # ------------------------------------------------------------ feeding

    def add_detections(self, file_name: str, bboxes: np.ndarray):
        for bbox in bboxes:
            self._detections[int(bbox[-1])].append(
                (self._insert_idx, file_name, bbox))
            self._insert_idx += 1

    def add_labels(self, file_name: str, bboxes: np.ndarray, diffs: np.ndarray):
        if len(bboxes) == 0:
            return
        classes = bboxes[:, -1].astype(int)
        for cls in set(classes.tolist()):
            sel = classes == cls
            sel_boxes = bboxes[sel][:, :4]
            sel_diffs = diffs[sel].astype(bool)
            perm = np.argsort(sel_diffs, kind='stable')  # easy first
            sel_boxes, sel_diffs = sel_boxes[perm], sel_diffs[perm]
            seen = np.zeros((len(AP_IOU_THRESHOLDS), len(sel_boxes)), bool)
            self._labels[file_name][cls] = _ClassLabel(sel_boxes, seen, sel_diffs)
            self._gt_count[cls] += int(np.sum(~sel_diffs))

    def evaluate(self) -> APResult:
        for batch in self.dataset.batches(self._num_workers, self._prefetch):
            with torch.inference_mode():
                per_image = self.predict(batch)
            for i in range(batch['count']):
                self.add_detections(batch['file_name'][i], per_image[i])
                self.add_labels(batch['file_name'][i], batch['bboxes'][i],
                                batch['difficult'][i])
        return self.compute_ap()

    # ----------------------------------------------------------- matching

    @staticmethod
    def _overlaps(gt: np.ndarray, bb: np.ndarray) -> np.ndarray:
        """VOC +1 pixel IoU of one detection vs all GT boxes."""
        ixmin = np.maximum(gt[:, 0], bb[0])
        iymin = np.maximum(gt[:, 1], bb[1])
        ixmax = np.minimum(gt[:, 2], bb[2])
        iymax = np.minimum(gt[:, 3], bb[3])
        iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
        ih = np.maximum(iymax - iymin + 1.0, 0.0)
        inter = iw * ih
        union = ((bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0) +
                 (gt[:, 2] - gt[:, 0] + 1.0) * (gt[:, 3] - gt[:, 1] + 1.0) - inter)
        return inter / union

    def _match_class(self, cls: int):
        """Greedy matching for one class: the native matcher, or the Python
        one when the evaluator was made with ``native=False``."""
        if self._native:
            return self._match_class_native(cls)
        return self._match_class_python(cls)

    def _match_class_native(self, cls: int):
        dets = sorted(self._detections[cls], key=lambda t: -t[2][4])
        det_boxes = np.array([d[2][:4] for d in dets], np.float32).reshape(-1, 4)
        # build per-file label-set tables for this class
        set_ids, gt_blocks, diff_blocks, offsets = {}, [], [], [0]
        det_set = np.empty(len(dets), np.int32)
        for i, (_, file_name, _) in enumerate(dets):
            label = self._labels[file_name].get(cls)
            if label is None:
                det_set[i] = -1
                continue
            if file_name not in set_ids:
                set_ids[file_name] = len(gt_blocks)
                gt_blocks.append(label.bboxes)
                diff_blocks.append(label.difficult)
                offsets.append(offsets[-1] + len(label.bboxes))
            det_set[i] = set_ids[file_name]
        gt = np.concatenate(gt_blocks) if gt_blocks else np.zeros((0, 4), np.float32)
        diff = np.concatenate(diff_blocks) if diff_blocks else np.zeros(0, bool)
        return native_matcher.match_class(
            det_boxes, det_set, gt, diff, np.array(offsets, np.int32),
            AP_IOU_THRESHOLDS)

    def _match_class_python(self, cls: int):
        dets = self._detections[cls]
        # descending score; stable sort keeps insertion order on ties
        dets = sorted(dets, key=lambda t: -t[2][4])
        n_iou = len(AP_IOU_THRESHOLDS)
        tp = np.zeros((n_iou, len(dets)))
        fp = np.zeros((n_iou, len(dets)))
        for d_idx, (_, file_name, bbox) in enumerate(dets):
            label = self._labels[file_name].get(cls)
            if label is None:
                fp[:, d_idx] = 1
                continue
            overlaps = self._overlaps(label.bboxes, bbox[:4])
            for iou_idx, thr in enumerate(AP_IOU_THRESHOLDS):
                pick, pick_iou = -1, min(thr, 1 - 1e-10)
                for m_idx, m_iou in enumerate(overlaps):
                    if label.seen[iou_idx, m_idx]:
                        continue
                    if pick > -1 and not label.difficult[pick] and \
                            label.difficult[m_idx]:
                        break
                    if m_iou < pick_iou:
                        continue
                    pick, pick_iou = m_idx, m_iou
                # pick == -1 indexes the LAST (most difficult) GT, as the
                # native matcher does
                if label.difficult[pick]:
                    continue
                if pick == -1 or label.seen[iou_idx, pick]:
                    fp[iou_idx, d_idx] = 1
                    continue
                tp[iou_idx, d_idx] = 1
                label.seen[iou_idx, pick] = True
        return tp, fp

    def compute_ap(self) -> APResult:
        n_cls, n_iou = len(self._classes), len(AP_IOU_THRESHOLDS)
        raw = np.zeros((n_cls, n_iou))
        for cls in self._detections:
            tp, fp = self._match_class(cls)
            fp = np.cumsum(fp, axis=1)
            tp = np.cumsum(tp, axis=1)
            denom = max(self._gt_count[cls], 1)
            rec = tp / denom
            prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
            raw[cls] = self._ap_from_pr(rec, prec)
        aps = raw.mean(axis=1)
        maps = raw.mean(axis=0)
        result = APResult(maps, aps, float(maps.mean()), raw,
                          self._classes, AP_IOU_THRESHOLDS)
        self.reset()
        return result

    @staticmethod
    def _ap_from_pr(recs: np.ndarray, precs: np.ndarray) -> np.ndarray:
        """Precision-envelope AP."""
        mrecs = np.pad(recs, ((0, 0), (1, 1)), constant_values=(0.0, 1.0))
        mpres = np.pad(precs, ((0, 0), (1, 1)), constant_values=0.0)
        # running max from the right = precision envelope
        mpres = np.flip(np.maximum.accumulate(np.flip(mpres, axis=1), axis=1), axis=1)
        return np.sum(np.diff(mrecs, axis=1) * mpres[:, 1:], axis=1)
