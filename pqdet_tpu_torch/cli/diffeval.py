"""Differential evaluation against the torch reference (the port of
``pqdet_tpu/cli/diffeval.py``).

Runs the SAME weights through both full evaluation pipelines, the port's
(``evaluation/predict.py`` + ``evaluation/evaluator.py``) and the
reference's (dataset eval augment -> DetectionModel -> recover_bboxes ->
torch_nms -> eval/evaluator.py AP), over the same image list, then reports
per-image detection parity and the AP delta.

    python -m pqdet_tpu_torch.cli.diffeval --weight m.ckpt --yaml exp.yaml \
        [--limit 500] [--out report.json] [--reference DIR] [--device cuda|cpu]

Needs the reference tree (``--reference`` or the PQDET_REFERENCE
environment variable); torchvision and yacs are stubbed functionally by
``utils/reference_bridge.py``. The reference model runs on the CPU, the
port's pipeline on ``--device``.
"""

from __future__ import annotations

import argparse
import copy
import io
import json
import sys

import numpy as np


def _match_detections(a: np.ndarray, b: np.ndarray, box_tol: float = 1.0,
                      score_tol: float = 1e-3):
    """Greedy one-to-one matching of two (M, 6) detection arrays
    [x1,y1,x2,y2,score,cls]; returns (matched, extra_a, extra_b)."""
    used = np.zeros(len(b), bool)
    matched = 0
    for row in a:
        best, best_d = -1, None
        for j in range(len(b)):
            if used[j] or int(b[j, 5]) != int(row[5]):
                continue
            if abs(b[j, 4] - row[4]) > score_tol:
                continue
            d = np.abs(b[j, :4] - row[:4]).max()
            if d <= box_tol and (best_d is None or d < best_d):
                best, best_d = j, d
        if best >= 0:
            used[best] = True
            matched += 1
    return matched, len(a) - matched, len(b) - int(used.sum())


def run_diffeval(cfg, weight: str, limit: int = 0, ref_path: str = None, device='cuda'):
    """Returns a report dict (keys below); asserts nothing, callers decide
    thresholds. The reference computes exact f32, so TF32 is off for
    cuDNN and matmuls while this runs (restored after), or every score
    would differ by ~1e-3 and the greedy matcher would find few pairs."""
    import torch
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _run_diffeval(cfg, weight, limit, ref_path, device)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


def _run_diffeval(cfg, weight: str, limit: int, ref_path: str, device):
    import torch
    from pqdet_tpu_torch.data.eval_data import EvalData
    from pqdet_tpu_torch.evaluation.evaluator import Evaluator
    from pqdet_tpu_torch.evaluation.predict import build_predict_pipeline, make_batch_predict
    from pqdet_tpu_torch.exporters.torch_convert import convert_to_torch_state_dict
    from pqdet_tpu_torch.model.factory import build_detector, inference_params
    from pqdet_tpu_torch.utils import reference_bridge

    ref_path = ref_path or reference_bridge.DEFAULT_REF
    ref = reference_bridge.import_reference(ref_path)

    # host-side float normalization, bit-matching the reference's own
    # preprocessing
    cfg = copy.deepcopy(cfg)
    cfg.eval.host_normalize = True
    if limit:
        cfg.eval.partial = limit

    # ---- the port ---------------------------------------------------------
    network, params, state, info = build_detector(None, weight_path=weight, device=device)
    fused = inference_params(network, params, state)  # f32 for comparison
    predict = make_batch_predict(build_predict_pipeline(network, cfg, device=device), fused)

    ours_dets = {}

    def capture_predict(batch):
        dets = predict(batch)
        for i in range(batch['count']):
            ours_dets[batch['file_name'][i]] = dets[i]
        return dets

    ap_ours = Evaluator(capture_predict, EvalData(cfg), cfg).evaluate()

    # ---- reference --------------------------------------------------------
    ref_model = ref.interpreter.DetectionModel(io.StringIO(info['cfg_text']))
    sd = convert_to_torch_state_dict(params, state, network)
    ref_model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    ref_model.eval()

    rcfg = ref.CfgNode()
    rcfg.eval = ref.CfgNode()
    rcfg.eval.score_threshold = cfg.eval.score_threshold
    rcfg.eval.iou_threshold = cfg.eval.iou_threshold
    rcfg.eval.input_size = cfg.eval.input_size
    rcfg.eval.batch_size = cfg.eval.batch_size
    rcfg.eval.partial = cfg.eval.partial
    rcfg.dataset = ref.CfgNode()
    rcfg.dataset.name = cfg.dataset.name
    rcfg.dataset.eval_txt_file = cfg.dataset.eval_txt_file
    rcfg.dataset.classes = list(cfg.dataset.classes)

    sys.path.insert(0, ref_path)
    try:
        from dataset.eval_dataset import EvalDataset as RefEvalDataset  # noqa
    finally:
        sys.path.remove(ref_path)
    ref_data = RefEvalDataset(rcfg)

    ref_dets = {}
    ref_eval = ref.evaluator.Evaluator(lambda t: ref_model(t), ref_data, rcfg)
    orig_add = ref_eval.add_detections

    def capture_add(file_name, bboxes):
        ref_dets[file_name] = np.asarray(bboxes)
        return orig_add(file_name, bboxes)

    ref_eval.add_detections = capture_add
    ap_ref = ref_eval.evaluate()

    # ---- compare ----------------------------------------------------------
    per_image = []
    total_m = total_a = total_b = 0
    for name, ours in ours_dets.items():
        theirs = ref_dets.get(name, np.zeros((0, 6), np.float32))
        if theirs.ndim != 2 or theirs.size == 0:
            theirs = np.zeros((0, 6), np.float32)
        m, ea, eb = _match_detections(ours, theirs)
        total_m += m
        total_a += ea
        total_b += eb
        per_image.append({'file': name, 'matched': m, 'extra_ours': ea, 'extra_ref': eb})

    return {
        'images': len(ours_dets),
        'detections_matched': total_m,
        'extra_ours': total_a,
        'extra_ref': total_b,
        'match_rate': total_m / max(total_m + total_a + total_b, 1),
        'AP_ours': float(ap_ours.AP),
        'AP_ref': float(ap_ref.AP),
        'AP50_ours': float(ap_ours.mAPs[0]),
        'AP50_ref': float(ap_ref.mAPs[0]),
        'AP_delta': abs(float(ap_ours.AP) - float(ap_ref.AP)),
        'AP50_delta': abs(float(ap_ours.mAPs[0]) - float(ap_ref.mAPs[0])),
        'per_image_mismatches': [r for r in per_image
                                 if r['extra_ours'] or r['extra_ref']][:50],
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description='differential eval against the torch '
                                                 'reference')
    parser.add_argument('--weight', required=True)
    parser.add_argument('--yaml', default=None)
    parser.add_argument('--limit', type=int, default=0)
    parser.add_argument('--out', default='')
    parser.add_argument('--reference', default=None)
    parser.add_argument('--device', default='cuda')
    args, rest = parser.parse_known_args(argv)

    from pqdet_tpu_torch.config import load_config, platform_device
    cfg = load_config(args.yaml, rest)
    args.device = platform_device(cfg, args.device)
    report = run_diffeval(cfg, args.weight, args.limit, args.reference, args.device)
    text = json.dumps(report, indent=2)
    print(text)
    if args.out:
        with open(args.out, 'w') as fw:
            fw.write(text)
    return report


if __name__ == '__main__':
    main()
