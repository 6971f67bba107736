"""Anchor k-means tool (the port of ``pqdet_tpu/cli/anchors.py``).

Clusters the GT (w, h) pairs of a training list with Lloyd's k-means under
the 1 - IoU(wh) metric. It is a host-only numpy tool: it reads labels and
runs on no device, so it takes no ``--device``.

    python -m pqdet_tpu_torch.cli.anchors --txt train.txt --dataset voc -k 9 \
        [key value ...]
"""

from __future__ import annotations

import argparse

import numpy as np


def iou_wh(whs: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """(N, 2) x (K, 2) -> (N, K) IoU of co-centred boxes."""
    inter = np.minimum(whs[:, None, 0], centers[None, :, 0]) * \
        np.minimum(whs[:, None, 1], centers[None, :, 1])
    union = whs[:, 0:1] * whs[:, 1:2] + \
        (centers[:, 0] * centers[:, 1])[None, :] - inter
    return inter / union


def kmeans_anchors(whs: np.ndarray, k: int = 9, iters: int = 100,
                   seed: int = 0) -> np.ndarray:
    """k-means under d = 1 - IoU; returns (k, 2) anchors sorted by area."""
    rng = np.random.RandomState(seed)
    centers = whs[rng.choice(len(whs), k, replace=False)].astype(np.float64)
    assign = None
    for _ in range(iters):
        d = 1.0 - iou_wh(whs, centers)
        new_assign = d.argmin(axis=1)
        if assign is not None and (new_assign == assign).all():
            break
        assign = new_assign
        for j in range(k):
            members = whs[assign == j]
            if len(members):
                centers[j] = np.median(members, axis=0)
    order = np.argsort(centers[:, 0] * centers[:, 1])
    return centers[order]


def collect_whs(txt_file: str, dataset: str, classes) -> np.ndarray:
    """(N, 2) widths and heights of every GT box of the images listed in
    ``txt_file``, in pixels (COCO's normalized boxes scaled by the image's
    size)."""
    from pqdet_tpu_torch.data.samples import sample_getter
    getter = sample_getter(dataset, mode='train', classes=classes)
    whs = []
    with open(txt_file) as fr:
        paths = [l.strip() for l in fr if l.strip()]
    for p in paths:
        bboxes = getter.label(p)
        if dataset.lower() == 'coco' and len(bboxes):
            bboxes = getter.to_absolute(bboxes, getter.shape(getter.image(p)))
        if len(bboxes):
            whs.append(bboxes[:, 2:4] - bboxes[:, 0:2])
    return np.concatenate(whs, axis=0)


def main(argv=None):
    parser = argparse.ArgumentParser(description='anchor k-means')
    parser.add_argument('--txt', required=True)
    parser.add_argument('--dataset', default='voc')
    parser.add_argument('-k', type=int, default=9)
    args, rest = parser.parse_known_args(argv)

    from pqdet_tpu_torch.config import load_config
    cfg = load_config(opts=rest)
    whs = collect_whs(args.txt, args.dataset, list(cfg.dataset.classes))
    print(f'{len(whs)} boxes')
    anchors = kmeans_anchors(whs, k=args.k)
    mean_iou = iou_wh(whs, anchors).max(axis=1).mean()
    print('anchors:', [[round(float(w), 1), round(float(h), 1)]
                       for w, h in anchors])
    print(f'mean best IoU: {mean_iou:.4f}')
    return anchors


if __name__ == '__main__':
    main()
