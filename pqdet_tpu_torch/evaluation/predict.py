"""The shared inference pipeline: normalize -> forward -> recover -> NMS.

The port of ``pqdet_tpu/evaluation/predict.py``: the one wiring every eval
and predict entry point goes through.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from pqdet_tpu_torch import resolve_device
from pqdet_tpu_torch.config import size_fix
from pqdet_tpu_torch.ops.postprocess import (NMSResult, letterbox_affine,
                                             nms_batch, nms_to_numpy,
                                             ratio_pad_affine, recover_bboxes)
from pqdet_tpu_torch.ops.preprocess import device_normalize
from pqdet_tpu_torch.utils import tracing

# dataset name -> on-device inverse affine of its eval resize
RECOVER_AFFINE_REGISTER = {
    'voc': letterbox_affine,
    'coco': letterbox_affine,
    'visdrone': functools.partial(ratio_pad_affine, resize_ratio=1.25, divisor=32),
}


def build_predict_pipeline(network, cfg, compute_dtype=None,
                           apply_fn: Optional[Callable] = None,
                           fused_ir: Optional[dict] = None, device='cuda'):
    """Returns ``run(params, images, shapes) -> NMSResult`` on ``device``.

    ``images``: (B, H, W, 3) uint8 (normalized on the device) or already
    normalized float; ``shapes``: (B, 2) original (h, w). ``apply_fn(params,
    images) -> (B, N, 5+C)`` overrides the forward (and ignores
    ``eval.s2d_stem``, as the JAX pipeline's does); the default is the
    network's walk with the stem folded by ``eval.s2d_stem``, through the
    fused-IR kernel when ``fused_ir`` (the table of
    ``ops.fused_ir.prepare_fused_ir``) is given. Runs under
    ``torch.inference_mode()``.
    """
    dev = resolve_device(device)
    affine = RECOVER_AFFINE_REGISTER[cfg.dataset.name.lower()]
    input_size = torch.tensor(size_fix(cfg.eval.input_size), dtype=torch.float32,
                              device=dev)
    ev = cfg.eval

    if apply_fn is None:
        s2d = int(cfg.eval.s2d_stem)

        def apply_fn(params, images):
            return network(params, {}, images, compute_dtype=compute_dtype,
                           fused_ir=fused_ir, s2d_stem=s2d)

    @torch.inference_mode()
    def run(params, images, shapes) -> NMSResult:
        with tracing.span('predict.upload'):
            images = torch.as_tensor(images, device=dev)
            shapes = torch.as_tensor(shapes, device=dev).to(torch.float32)
        with tracing.span('predict.normalize'):
            images = device_normalize(images)
        with tracing.span('predict.forward'):
            preds = apply_fn(params, images)
        with tracing.span('predict.recover'):
            recovered = recover_bboxes(preds, input_size, shapes, affine=affine)
        with tracing.span('predict.nms'):
            return nms_batch(recovered, ev.score_threshold, ev.iou_threshold,
                             ev.max_detections, ev.pool_factor, ev.nms_method,
                             ev.nms_sigma)

    return run


def make_batch_predict(run, params) -> Callable[[Dict], List[np.ndarray]]:
    """Wrap a pipeline into the evaluator's predict contract:
    batch dict -> list of per-image (M, 6) numpy detections.

    Two saturation modes are warned about, once each:

    - pool overflow: more above-threshold (box, class) pairs than
      ``max_detections * pool_factor``; candidates beyond the pool never
      enter NMS. Fix: raise ``eval.pool_factor``.
    - output saturation: an image KEPT exactly ``max_detections`` boxes,
      so further survivors were dropped. Fix: raise
      ``eval.max_detections``.
    """
    warned = {'overflow': False, 'saturated': False}

    def predict(batch):
        with tracing.span('predict.request'):
            res = run(params, batch['image'], batch['shape'])
            with tracing.span('predict.copy_home'):
                res = NMSResult(*(t.cpu().numpy() for t in res))
            with tracing.span('predict.to_numpy'):
                return to_numpy(res, batch['count'])

    def to_numpy(res, n):
        max_det = res.valid.shape[1]
        n_over = int(res.overflow[:n].sum())
        n_sat = int((res.valid[:n].sum(axis=1) == max_det).sum())
        tracing.count('predict.images', n)
        tracing.count('predict.overflow_images', n_over)
        tracing.count('predict.saturated_images', n_sat)
        if n_over and not warned['overflow']:
            warned['overflow'] = True
            print(f'WARNING: NMS candidate pool overflowed on {n_over} '
                  f'image(s) in a batch (pool = eval.max_detections * '
                  f'eval.pool_factor top-scored candidates; the rest '
                  f'never enter NMS). Double eval.pool_factor.')
        if n_sat and not warned['saturated']:
            warned['saturated'] = True
            print(f'WARNING: NMS output saturated on {n_sat} image(s) in '
                  f'a batch — exactly eval.max_detections={max_det} boxes '
                  f'kept, so lower-scored survivors were dropped. Raise '
                  f'eval.max_detections (e.g. {2 * max_det}).')
        return [nms_to_numpy(NMSResult(*(x[i] for x in res))) for i in range(n)]
    return predict
