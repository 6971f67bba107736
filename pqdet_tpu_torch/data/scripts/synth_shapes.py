"""Synthetic shapes dataset generator in the VOC layout (the port of
``pqdet_tpu/data/scripts/synth_shapes.py``): coloured squares, circles and
triangles on noisy backgrounds, written by cv2 as the JAX package writes
them, so one seed gives both packages the same corpus.

    python -m pqdet_tpu_torch.data.scripts.synth_shapes --root DIR \
        [--n 300] [--size 320] [--seed 0] [--holdout 0.13] [--vary-aspect]
"""

import argparse
import os

import cv2
import numpy as np

CLASSES = ['square', 'circle', 'triangle']
COLORS = [(40, 200, 240), (220, 80, 60), (90, 230, 90)]


def generate(root: str, n: int = 300, size: int = 320, seed: int = 0,
             holdout: float = 0.13, vary_aspect: bool = False):
    """Write ``n`` images with 1-3 shapes each under ``root`` (JPEGImages/,
    Annotations/, train.txt, test.txt: the last ``holdout`` share is the
    test split). ``vary_aspect`` draws each side in [0.6, 1.4) x size."""
    img_dir = os.path.join(root, 'JPEGImages')
    ann_dir = os.path.join(root, 'Annotations')
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        if vary_aspect:
            h = int(rng.randint(size * 6 // 10, size * 14 // 10))
            w = int(rng.randint(size * 6 // 10, size * 14 // 10))
        else:
            h = w = size
        img = rng.randint(20, 90, (h, w, 3), np.uint8)
        objs = []
        for _ in range(rng.randint(1, 4)):
            cls = rng.randint(len(CLASSES))
            s = rng.randint(size // 8, size * 2 // 7)
            x1 = rng.randint(0, w - s)
            y1 = rng.randint(0, h - s)
            color = tuple(int(c + rng.randint(-25, 25)) for c in COLORS[cls])
            if cls == 0:
                cv2.rectangle(img, (x1, y1), (x1 + s, y1 + s), color, -1)
            elif cls == 1:
                cv2.circle(img, (x1 + s // 2, y1 + s // 2), s // 2, color, -1)
            else:
                pts = np.array([[x1 + s // 2, y1], [x1, y1 + s], [x1 + s, y1 + s]])
                cv2.fillPoly(img, [pts], color)
            objs.append((CLASSES[cls], x1, y1, x1 + s, y1 + s))
        p = os.path.join(img_dir, f's{i}.jpg')
        cv2.imwrite(p, img)
        xml = '<annotation>' + ''.join(
            f'<object><name>{name}</name><difficult>0</difficult><bndbox>'
            f'<xmin>{a}</xmin><ymin>{b}</ymin><xmax>{c}</xmax><ymax>{d}</ymax>'
            f'</bndbox></object>' for name, a, b, c, d in objs) + '</annotation>'
        with open(os.path.join(ann_dir, f's{i}.xml'), 'w') as fw:
            fw.write(xml)
        paths.append(p)
    split = int(n * (1 - holdout))
    with open(os.path.join(root, 'train.txt'), 'w') as fw:
        fw.write('\n'.join(paths[:split]))
    with open(os.path.join(root, 'test.txt'), 'w') as fw:
        fw.write('\n'.join(paths[split:]))
    return paths


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--root', required=True)
    parser.add_argument('--n', type=int, default=300)
    parser.add_argument('--size', type=int, default=320)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--holdout', type=float, default=0.13)
    parser.add_argument('--vary-aspect', action='store_true')
    args = parser.parse_args()
    paths = generate(args.root, args.n, args.size, args.seed, args.holdout,
                     args.vary_aspect)
    print(f'{len(paths)} images under {args.root} (train.txt / test.txt)')


if __name__ == '__main__':
    main()
