"""Discriminative synthetic detection benchmark in the VOC layout (the port
of ``pqdet_tpu/data/scripts/synth_clutter.py``): the same numpy draws and
cv2 drawing calls, so one seed gives both packages the same corpus, the
data of ``yamls/clutter.yaml``.

The plain shapes set (synth_shapes.py) saturates: every model arc lands at
AP50 97.7-98.7, so a 1-point AP regression (multi-scale training, bf16,
NMS pool, quantisation) is invisible. This generator is tuned so a
mobilenetv2-fpn trained from scratch lands at AP50 ~0.6-0.8, making
compression-ladder deltas measurable:

- 20 classes = 5 shapes x 4 hue families, with hue jitter wide enough that
  neighbouring families brush against each other (classification errors).
- occlusion: objects overlap in z-order (IoU up to ~0.5) and random
  occluder bars cut across them.
- clutter: textured backgrounds (smoothed low-frequency noise), random
  line segments, and NON-class distractor shapes (stars/crosses/rings) in
  class-like colors.
- crowding: 2-24 objects per image, half of them spawned in gaussian
  clusters around hotspots.
- scale: log-uniform object size from 10 px to ~40% of the image side.
- photometric: brightness/contrast jitter, gaussian noise, JPEG quality
  jitter (55-95).

VOC layout (JPEGImages/Annotations/train.txt/test.txt) - drop-in for
dataset.name='voc' with dataset.classes=CLASSES.

    python -m pqdet_tpu_torch.data.scripts.synth_clutter --root DIR \
        [--n 3000] [--size 512] [--seed 0] [--difficulty 1.0]
"""

import argparse
import math
import os

import cv2
import numpy as np

SHAPES = ['square', 'circle', 'triangle', 'diamond', 'bar']
HUES = ['red', 'yellow', 'green', 'blue']
CLASSES = [f'{h}_{s}' for s in SHAPES for h in HUES]  # 20 classes

# BGR hue family centers; jitter pushes samples toward neighbours
HUE_BGR = {
    'red': (50, 50, 210),
    'yellow': (60, 200, 220),
    'green': (80, 190, 70),
    'blue': (210, 120, 60),
}


def _hue_sample(rng, hue: str, jitter: float):
    base = np.array(HUE_BGR[hue], np.float32)
    # jitter in BGR space, wide enough that red/yellow and green/blue
    # samples can land between families
    c = base + rng.randn(3) * 28.0 * jitter
    return tuple(int(v) for v in np.clip(c, 0, 255))


def _draw_shape(img, shape: str, x1, y1, s, color, rng):
    x2, y2 = x1 + s, y1 + s
    if shape == 'square':
        cv2.rectangle(img, (x1, y1), (x2, y2), color, -1)
    elif shape == 'circle':
        cv2.circle(img, (x1 + s // 2, y1 + s // 2), s // 2, color, -1)
    elif shape == 'triangle':
        pts = np.array([[x1 + s // 2, y1], [x1, y2], [x2, y2]])
        cv2.fillPoly(img, [pts], color)
    elif shape == 'diamond':
        pts = np.array([[x1 + s // 2, y1], [x2, y1 + s // 2],
                        [x1 + s // 2, y2], [x1, y1 + s // 2]])
        cv2.fillPoly(img, [pts], color)
    elif shape == 'bar':
        # horizontal bar filling the box's middle third (extreme aspect)
        cv2.rectangle(img, (x1, y1 + s // 3), (x2, y2 - s // 3), color, -1)


def _draw_distractor(img, rng, w, h, jitter):
    kind = rng.randint(3)
    s = int(np.exp(rng.uniform(math.log(8), math.log(max(9, w // 4)))))
    x1 = rng.randint(0, max(1, w - s))
    y1 = rng.randint(0, max(1, h - s))
    hue = HUES[rng.randint(len(HUES))]
    color = _hue_sample(rng, hue, jitter)
    if kind == 0:   # ring (circle outline - not the filled-circle class)
        cv2.circle(img, (x1 + s // 2, y1 + s // 2), s // 2, color,
                   max(1, s // 8))
    elif kind == 1:  # cross
        t = max(1, s // 5)
        cv2.rectangle(img, (x1 + s // 2 - t, y1), (x1 + s // 2 + t, y1 + s),
                      color, -1)
        cv2.rectangle(img, (x1, y1 + s // 2 - t), (x1 + s, y1 + s // 2 + t),
                      color, -1)
    else:           # 4-point star
        cx, cy, r = x1 + s // 2, y1 + s // 2, s // 2
        pts = []
        for k in range(8):
            ang = k * math.pi / 4
            rad = r if k % 2 == 0 else r // 3
            pts.append([int(cx + rad * math.cos(ang)),
                        int(cy + rad * math.sin(ang))])
        cv2.fillPoly(img, [np.array(pts)], color)


def _background(rng, h, w):
    """Low-frequency smoothed noise texture + random line segments."""
    small = rng.randint(0, 255, (h // 16 + 1, w // 16 + 1, 3), np.uint8)
    bg = cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)
    bg = (bg.astype(np.float32) * 0.35 + 60).astype(np.uint8)
    for _ in range(rng.randint(4, 12)):
        p1 = (rng.randint(0, w), rng.randint(0, h))
        p2 = (rng.randint(0, w), rng.randint(0, h))
        col = tuple(int(c) for c in rng.randint(30, 200, 3))
        cv2.line(bg, p1, p2, col, rng.randint(1, 4))
    return bg


def _coverage(a, b):
    """Intersection over the SMALLER box's area — unlike IoU this catches a
    large box fully burying a small one (which would be unlearnable label
    noise), not just similar-size overlaps."""
    ix = max(0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    smaller = min((a[2] - a[0]) * (a[3] - a[1]),
                  (b[2] - b[0]) * (b[3] - b[1]))
    return inter / max(smaller, 1)


def generate(root: str, n: int = 3000, size: int = 512, seed: int = 0,
             holdout: float = 0.12, difficulty: float = 1.0):
    """Write ``n`` images under ``root`` (JPEGImages/, Annotations/,
    train.txt, test.txt: the last ``holdout`` share is the test split).
    ``difficulty`` scales occlusion, clutter and noise."""
    img_dir = os.path.join(root, 'JPEGImages')
    ann_dir = os.path.join(root, 'Annotations')
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    jitter = difficulty
    paths = []
    for i in range(n):
        h = int(rng.randint(size * 7 // 10, size * 13 // 10))
        w = int(rng.randint(size * 7 // 10, size * 13 // 10))
        img = _background(rng, h, w)

        for _ in range(rng.randint(2, 2 + int(8 * difficulty))):
            _draw_distractor(img, rng, w, h, jitter)

        # crowding: half the objects cluster around 1-3 hotspots
        n_obj = rng.randint(2, 25)
        hotspots = [(rng.randint(0, w), rng.randint(0, h))
                    for _ in range(rng.randint(1, 4))]
        objs = []
        boxes = []
        for k in range(n_obj):
            cls = rng.randint(len(CLASSES))
            shape, hue = SHAPES[cls // len(HUES)], HUES[cls % len(HUES)]
            s = int(np.exp(rng.uniform(math.log(10),
                                       math.log(max(12, int(size * 0.4))))))
            s = min(s, min(h, w) - 2)
            if k % 2 == 0 or not hotspots:
                x1 = rng.randint(0, max(1, w - s))
                y1 = rng.randint(0, max(1, h - s))
            else:
                hx, hy = hotspots[rng.randint(len(hotspots))]
                x1 = int(np.clip(hx + rng.randn() * size * 0.08, 0,
                                 max(1, w - s)))
                y1 = int(np.clip(hy + rng.randn() * size * 0.08, 0,
                                 max(1, h - s)))
            box = (x1, y1, x1 + s, y1 + s)
            # cap occlusion: reject if it would bury (or be buried by) an
            # earlier object beyond partial visibility
            if any(_coverage(box, bx) > 0.55 * min(difficulty, 1.0)
                   for bx in boxes):
                continue
            color = _hue_sample(rng, hue, jitter)
            _draw_shape(img, shape, x1, y1, s, color, rng)
            boxes.append(box)
            objs.append((CLASSES[cls],) + box)

        # occluder bars over the scene (objects stay annotated: partial
        # visibility, the detector must see through it)
        for _ in range(rng.randint(0, 1 + int(3 * difficulty))):
            x = rng.randint(0, w)
            t = rng.randint(3, max(4, size // 40))
            col = tuple(int(c) for c in rng.randint(20, 230, 3))
            if rng.rand() < 0.5:
                cv2.rectangle(img, (x, 0), (min(w, x + t), h), col, -1)
            else:
                y = rng.randint(0, h)
                cv2.rectangle(img, (0, y), (w, min(h, y + t)), col, -1)

        # photometric: brightness/contrast jitter + gaussian noise
        alpha = 1.0 + rng.uniform(-0.25, 0.25) * difficulty
        beta = rng.uniform(-25, 25) * difficulty
        img = np.clip(img.astype(np.float32) * alpha + beta +
                      rng.randn(h, w, 3) * 6.0 * difficulty,
                      0, 255).astype(np.uint8)

        p = os.path.join(img_dir, f'c{i}.jpg')
        cv2.imwrite(p, img,
                    [cv2.IMWRITE_JPEG_QUALITY, int(rng.randint(55, 96))])
        xml = '<annotation>' + ''.join(
            f'<object><name>{name}</name><difficult>0</difficult><bndbox>'
            f'<xmin>{a}</xmin><ymin>{b}</ymin><xmax>{c}</xmax><ymax>{d}</ymax>'
            f'</bndbox></object>' for name, a, b, c, d in objs) + \
            '</annotation>'
        with open(os.path.join(ann_dir, f'c{i}.xml'), 'w') as fw:
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
    parser.add_argument('--n', type=int, default=3000)
    parser.add_argument('--size', type=int, default=512)
    parser.add_argument('--seed', type=int, default=0)
    parser.add_argument('--holdout', type=float, default=0.12)
    parser.add_argument('--difficulty', type=float, default=1.0)
    args = parser.parse_args()
    paths = generate(args.root, args.n, args.size, args.seed, args.holdout,
                     args.difficulty)
    print(f'{len(paths)} images under {args.root} (train.txt / test.txt)')


if __name__ == '__main__':
    main()
