"""Single-image prediction CLI (the port of ``pqdet_tpu/cli/predict.py``).

    python -m pqdet_tpu_torch.cli.predict --img path.jpg --weight model.ckpt \
        [--cfg model.cfg|zoo-name] [--yaml exp.yaml] [--output out.jpg] \
        [--device cuda|cpu] [key value ...]

Letterbox, forward, recover and NMS through the predict pipeline; prints
the detections, draws them and writes ``<img>_mark.jpg``.
"""

from __future__ import annotations

import argparse
import os

import cv2
import numpy as np
import torch

from pqdet_tpu_torch import resolve_device


def draw_detections(image_rgb: np.ndarray, detections: np.ndarray,
                    class_names, color=(0, 255, 0)) -> np.ndarray:
    img = image_rgb.copy()
    for det in detections:
        x1, y1, x2, y2 = (int(round(v)) for v in det[:4])
        score, cls = det[4], int(det[5])
        name = class_names[cls] if cls < len(class_names) else str(cls)
        cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)
        cv2.putText(img, f'{name} {score:.2f}', (x1, max(y1 - 5, 0)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.4, color)
    return img


def predict_image(cfg, img_path: str, weight_path: str = None,
                  cfg_path: str = None, device='cuda'):
    """Returns (image_rgb, (M, 6) detections)."""
    from pqdet_tpu_torch.config import size_fix
    from pqdet_tpu_torch.data.samples import EVAL_AUGMENT_REGISTER
    from pqdet_tpu_torch.evaluation.predict import build_predict_pipeline
    from pqdet_tpu_torch.model.factory import build_detector, inference_params
    from pqdet_tpu_torch.ops.postprocess import NMSResult, nms_to_numpy

    dev = resolve_device(device)
    cfg_text = None
    if cfg_path:
        from pqdet_tpu_torch.zoo import MODEL_ZOO, get_cfg
        cfg_text = get_cfg(cfg_path, num_classes=len(cfg.dataset.classes)) \
            if cfg_path in MODEL_ZOO else open(cfg_path).read()
    network, params, state, _ = build_detector(cfg_text, weight_path=weight_path, device=dev)
    fused = inference_params(network, params, state)

    image = cv2.imread(img_path)
    if image is None:
        raise FileNotFoundError(f'image not found: {img_path}')
    image = cv2.cvtColor(image, cv2.COLOR_BGR2RGB)
    shape = np.array(image.shape[:2], np.float32)
    pre, _ = EVAL_AUGMENT_REGISTER[cfg.dataset.name.lower()](size_fix(cfg.eval.input_size))(
        image, [], None)

    run = build_predict_pipeline(network, cfg, device=dev)
    res = run(fused, torch.from_numpy(pre[None]), torch.from_numpy(shape[None]))
    return image, nms_to_numpy(NMSResult(*(t[0].cpu().numpy() for t in res)))


def main():
    parser = argparse.ArgumentParser(description='single image prediction')
    parser.add_argument('--img', required=True)
    parser.add_argument('--weight', default='')
    parser.add_argument('--cfg', default='')
    parser.add_argument('--yaml', default=None)
    parser.add_argument('--output', default='')
    parser.add_argument('--device', default='cuda')
    args, rest = parser.parse_known_args()

    from pqdet_tpu_torch.config import load_config, platform_device
    cfg = load_config(args.yaml, rest)
    args.device = platform_device(cfg, args.device)
    image, dets = predict_image(cfg, args.img, weight_path=args.weight or None,
                                cfg_path=args.cfg or None, device=args.device)
    print(f'{len(dets)} detections')
    for d in dets:
        print('  box=({:.1f},{:.1f},{:.1f},{:.1f}) score={:.3f} class={}'.format(
            *d[:4], d[4], cfg.dataset.classes[int(d[5])]))
    marked = draw_detections(image, dets, cfg.dataset.classes)
    out = args.output or os.path.splitext(args.img)[0] + '_mark.jpg'
    cv2.imwrite(out, cv2.cvtColor(marked, cv2.COLOR_RGB2BGR))
    print(f'saved: {out}')


if __name__ == '__main__':
    main()
