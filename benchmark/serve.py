"""Serving cells: a closed loop of one caller sending batches of host uint8
images to the port's predict pipeline, each request timed from the call to
its detections as numpy on the host.

The path is ``evaluation/predict.py``'s ``build_predict_pipeline`` and
``make_batch_predict``, the one ``cli.bench eval`` and the trainer's eval
call: normalize on the device, the forward (``model/network.py``'s walk in
bf16 with the fused-IR table, or ``compress/quantized.py``'s
``Int8Inference`` in kernel mode after calibration and conversion), then
recover and NMS (``ops/postprocess.py``) and the copy home.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from . import compare, weights
from .reference import cfg as C
from .reference import int8 as RQ
from .reference import net as RN
from .reference import post as RP

REF_BLOCK = 16          # images a reference block computes at once


def make_pool(t: Dict, gen: torch.Generator, device) -> List[Dict]:
    """``t['pool']`` batches of ``t['batch']`` letterboxed images: uniform
    noise at the scale of an original side drawn from ``t['sides']``, the
    rest the letterbox's grey 128; host uint8 NHWC, as a caller holds them."""
    b, s = t['batch'], t['size']
    pool = []
    ar = torch.arange(s, device=device)
    for _ in range(t['pool']):
        img = torch.randint(0, 256, (b, s, s, 3), generator=gen, device=device,
                            dtype=torch.uint8)
        hw = torch.randint(t['sides'][0], t['sides'][1], (b, 2), generator=gen,
                           device=device).double()
        r = torch.min(s / hw, dim=1, keepdim=True).values
        inner = torch.round(r * hw)
        lo = torch.floor((s - inner) / 2)
        rows = (ar >= lo[:, :1]) & (ar < lo[:, :1] + inner[:, :1])
        cols = (ar >= lo[:, 1:]) & (ar < lo[:, 1:] + inner[:, 1:])
        mask = rows[:, :, None] & cols[:, None, :]
        img = torch.where(mask[..., None], img, torch.full_like(img, 128))
        pool.append({'image': img.cpu().numpy(), 'shape': hw.long().cpu().numpy(),
                     'count': b})
    return pool


class Serve:
    """One serving cell: ``setup``, ``window``, ``free``, ``check``."""

    def __init__(self, cell: Dict, seed_gen, device, tracer):
        self.cell, self.t, self.device, self.tracer = cell, cell['traffic'], device, tracer
        self.lays = C.layers(cell['cfg_text'])
        self.gens = seed_gen
        self.outputs: List = []
        self.overflow: List[torch.Tensor] = []
        self.patched: List = []

    def prepare_inputs(self):
        self.pool = make_pool(self.t, self.gens('pool'), self.device)

    # ----------------------------------------------------------- program
    def setup(self):
        import pqdet_tpu_torch.evaluation.predict as P
        from pqdet_tpu_torch.config import Config
        from pqdet_tpu_torch.model.network import DetectionNetwork
        t, dev = self.t, self.device
        self.params, self.state = weights.make(self.lays, self.gens('weights'),
                                               self.cell['config']['gain'], dev)
        self.prepare_inputs()
        pcfg = Config()
        pcfg.eval.input_size = t['size']
        for k in ('score_threshold', 'iou_threshold', 'max_detections', 'pool_factor'):
            setattr(pcfg.eval, k, t[k])
        text = self.cell['cfg_text']
        tr = self.tracer
        if t['precision'] == 'bf16':
            from pqdet_tpu_torch.model.factory import inference_params
            from pqdet_tpu_torch.model.network import cast_params
            from pqdet_tpu_torch.ops.fused_ir import prepare_fused_ir
            net = DetectionNetwork.from_cfg(text)
            fused = inference_params(net, self.params, self.state)
            table = prepare_fused_ir(net, fused) if t['fused_ir'] else None
            served = cast_params(fused, torch.bfloat16)
            s2d = int(pcfg.eval.s2d_stem)

            def forward(p, x):      # the pipeline's own default forward
                return net(p, {}, x, compute_dtype=torch.bfloat16, fused_ir=table,
                           s2d_stem=s2d)
        else:
            from pqdet_tpu_torch.compress.qat import QuantCtx, prepare_qat_state
            from pqdet_tpu_torch.compress.quantized import Int8Inference, convert_to_int8
            from pqdet_tpu_torch.ops.preprocess import device_normalize
            net = DetectionNetwork.from_cfg(text, quant=True)
            qp, qs = prepare_qat_state(net, self.params, self.state)
            with torch.inference_mode():
                for x in self.calib_batches():
                    ctx = QuantCtx(qs['quant'], observing=True)
                    net(qp, qs, device_normalize(torch.as_tensor(x, device=dev)),
                        quant_ctx=ctx)
                    qs = {**qs, 'quant': ctx.new_obs}
                qparams = convert_to_int8(net, qp, qs)
            forward = Int8Inference(net, mode='kernel').apply
            served = Int8Inference.prepare(qparams, mode='kernel', network=net)
        self.install_spans(P)
        run = P.build_predict_pipeline(net, pcfg, apply_fn=tr.wrap('serve.forward', forward),
                                       device=dev)
        self.predict = P.make_batch_predict(run, served)
        for i in range(t['warmup']):
            self.predict(self.pool[i % len(self.pool)])
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    def install_spans(self, P):
        """Wrap the pipeline's stages, as ``evaluation/predict.py`` calls
        them, in spans (which open only in a traced run), the same code in
        every run; NMS's wrapper also keeps each batch's overflow flags."""
        tr, overflow = self.tracer, self.overflow

        def keep_overflow(nms):
            def inner(*args, **kwargs):
                res = nms(*args, **kwargs)
                overflow.append(res.overflow)
                return res
            return inner
        self.patched = []
        for name, attr, extra in (('serve.normalize', 'device_normalize', None),
                                  ('serve.recover', 'recover_bboxes', None),
                                  ('serve.nms', 'nms_batch', keep_overflow)):
            old = getattr(P, attr)
            new = tr.wrap(name, extra(old) if extra else old)
            setattr(P, attr, new)
            self.patched.append((P, attr, old, new))

    def calib_batches(self):
        t = self.t
        return [self.pool[i % len(self.pool)]['image'][:t['calib_batch']]
                for i in range(t['calib_passes'])]

    def window(self, seconds: float) -> Dict:
        lat, n_img = [], 0
        pool, predict, span = self.pool, self.predict, self.tracer.span
        self.overflow.clear()
        self.window_from = len(self.outputs)
        t0 = time.perf_counter()
        i = 0
        while True:
            req = pool[i % len(pool)]
            s = time.perf_counter()
            with span('serve.request'):
                dets = predict(req)
            e = time.perf_counter()
            lat.append(e - s)
            n_img += len(dets)
            self.outputs.append((i % len(pool), dets))
            i += 1
            if e - t0 >= seconds:
                break
        wall = e - t0
        return {'serve_images_per_s': n_img / wall,
                'serve_request_ms_p95': float(np.percentile(np.asarray(lat) * 1e3, 95)),
                'requests': i, 'images': n_img, 'wall_s': wall}

    def counters(self) -> Dict[str, int]:
        """Images served in the last window, those that kept exactly
        ``max_detections`` (saturated) and those whose NMS candidate pool
        overflowed (more candidates above the threshold than
        ``max_detections * pool_factor``)."""
        outs = self.outputs[self.window_from:]
        n = sum(len(d) for _, d in outs)
        sat = sum(len(x) == self.t['max_detections'] for _, d in outs for x in d)
        over = sum(int(o[:len(d)].sum()) for o, (_, d) in zip(self.overflow, outs))
        return {'images': n, 'saturated_images': sat, 'overflow_images': over}

    def free(self):
        for k in ('predict', 'params', 'state'):
            self.__dict__.pop(k, None)
        for module, attr, old, new in self.patched:
            if getattr(module, attr) is new:
                setattr(module, attr, old)
        self.patched = []

    # --------------------------------------------------------- reference
    def check(self, sample_gen) -> Dict[str, float]:
        """The numbers of ``compare``: a seeded sample of the finished
        requests against the reference."""
        t = self.t
        n = len(self.outputs)
        pick = torch.randperm(n, generator=sample_gen)[:t['check_requests']].tolist()
        return compare.worst([row for i in pick for row in self.compare_request(
            *self.outputs[i], self.reference_model())])

    def reference_model(self, lowp=None):
        """What the reference needs to serve: its params, or its int8 model
        calibrated on the same images (``lowp`` 'fp8' or 'int4': the control)."""
        key = ('model', lowp)
        if key not in self.__dict__:
            params, state = weights.make(self.lays, self.gens('weights'),
                                         self.cell['config']['gain'], self.device)
            if self.t['precision'] == 'int8':
                lv, wm = (15, 7) if lowp == 'int4' else (255, 127)
                with RN.no_tf32():
                    calib = [RN.normalize(torch.as_tensor(x, device=self.device))
                             for x in self.calib_batches()]
                    obs = RQ.calibrate(self.lays, params, state, calib, lv, wm)
                    self.__dict__[key] = (RQ.convert(self.lays, params, state, obs, lv, wm),
                                          lowp)
            else:
                self.__dict__[key] = ((params, state), lowp)
        return self.__dict__[key]

    def reference_preds(self, images_u8: np.ndarray, model) -> torch.Tensor:
        m, lowp = model
        x = RN.normalize(torch.as_tensor(images_u8, device=self.device))
        with RN.no_tf32():
            if self.t['precision'] == 'int8':
                return RQ.infer(self.lays, m, x, 15 if lowp == 'int4' else 255)
            return RN.infer(self.lays, m[0], m[1], x, lowp)

    def compare_request(self, pool_i: int, dets: List[np.ndarray], model) -> List[Dict]:
        t, req = self.t, self.pool[pool_i]
        rows = []
        for b0 in range(0, req['count'], REF_BLOCK):
            imgs = req['image'][b0:b0 + REF_BLOCK]
            hw = torch.as_tensor(req['shape'][b0:b0 + REF_BLOCK], device=self.device)
            boxes, scores = RP.recover(self.reference_preds(imgs, model), t['size'], hw)
            kept_all = RP.nms(boxes, scores, t['score_threshold'], t['iou_threshold'],
                              t['max_detections'], t['pool_factor'])
            for j, kept in enumerate(kept_all):
                ratio = t['size'] / float(hw[j].max())
                rows.append(compare.serve_image(dets[b0 + j], boxes[j], scores[j], kept,
                                                ratio, t['profile_ranks']))
        return rows

    def control(self, lowp: str) -> Dict[str, float]:
        """The control's numbers: the reference at ``lowp`` served in the
        program's place, on the requests ``check`` samples first."""
        t = self.t
        rows = []
        for pool_i in range(min(t['check_requests'], len(self.pool))):
            req = self.pool[pool_i]
            served = []
            for b0 in range(0, req['count'], REF_BLOCK):
                imgs = req['image'][b0:b0 + REF_BLOCK]
                hw = torch.as_tensor(req['shape'][b0:b0 + REF_BLOCK], device=self.device)
                boxes, scores = RP.recover(self.reference_preds(imgs, self.reference_model(lowp)),
                                           t['size'], hw)
                served += RP.nms(boxes, scores, t['score_threshold'], t['iou_threshold'],
                                 t['max_detections'], t['pool_factor'])
            rows += self.compare_request(pool_i, served, self.reference_model())
        return compare.worst(rows)
