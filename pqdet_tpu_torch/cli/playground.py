"""Augmentation playground (the port of ``pqdet_tpu/cli/playground.py``): a
grid of train-time augmented views of one image, with their boxes drawn,
written as one image (headless).

    python -m pqdet_tpu_torch.cli.playground --img path.jpg [--yaml exp.yaml] \
        [--n 8] [--seed 0] [--out playground.jpg] [key value ...]

The views go through the train chain of ``dataset.name`` (voc, coco or
visdrone) at 416x416, the image itself as every mixup and mosaic partner,
each view drawing from one ``np.random.RandomState(seed)`` in turn (JAX's
playground draws from the global ``np.random``: seeded alike, the views
are its views). Runs on the host only.
"""

from __future__ import annotations

import argparse

import cv2
import numpy as np

from pqdet_tpu_torch.data import augment
from pqdet_tpu_torch.data.samples import sample_getter

PLAYGROUND_SIZE = (416, 416)


def augmented_samples(cfg, img_path: str, n: int = 8, seed=None):
    """``n`` augmented RGB uint8 views of ``img_path`` with their boxes drawn."""
    getter = sample_getter(cfg.dataset.name, mode='train', classes=list(cfg.dataset.classes))
    getter.set_train_augment(cfg.augment, PLAYGROUND_SIZE, lambda rng: img_path)
    rng = np.random.RandomState(seed)
    outs = []
    for _ in range(n):
        image, bboxes = getter(img_path, rng)
        if image.dtype != np.uint8:     # a host-normalized float chain
            image, _ = augment.DeNormalize()(np.asarray(image, np.float32), [])
        image = np.ascontiguousarray(image, dtype=np.uint8)
        for bb in np.asarray(bboxes, np.float32):
            x1, y1, x2, y2 = (int(round(v)) for v in bb[:4])
            cv2.rectangle(image, (x1, y1), (x2, y2), (0, 255, 0), 2)
        outs.append(image)
    return outs


def grid(images, cols: int = 4, pad: int = 4) -> np.ndarray:
    """The images row by row, ``cols`` a row, on a dark canvas."""
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    rows = (len(images) + cols - 1) // cols
    canvas = np.full((rows * (h + pad), cols * (w + pad), 3), 32, np.uint8)
    for i, im in enumerate(images):
        r, c = divmod(i, cols)
        canvas[r * (h + pad):r * (h + pad) + im.shape[0],
               c * (w + pad):c * (w + pad) + im.shape[1]] = im
    return canvas


def main(argv=None):
    parser = argparse.ArgumentParser(description='augment playground')
    parser.add_argument('--img', required=True)
    parser.add_argument('--yaml', default=None)
    parser.add_argument('--n', type=int, default=8)
    parser.add_argument('--seed', type=int, default=None)
    parser.add_argument('--out', default='playground.jpg')
    args, rest = parser.parse_known_args(argv)

    from pqdet_tpu_torch.config import load_config
    cfg = load_config(args.yaml, rest)
    samples = augmented_samples(cfg, args.img, args.n, args.seed)
    out = grid(samples)
    if not cv2.imwrite(args.out, cv2.cvtColor(out, cv2.COLOR_RGB2BGR)):
        raise OSError(f'could not write {args.out}')
    print(f'saved: {args.out} ({len(samples)} augmented views)')
    return out


if __name__ == '__main__':
    main()
