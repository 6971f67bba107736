"""Host-side image and box augmentations (numpy + cv2), the port of the host
chain of ``pqdet_tpu/data/augment.py``.

Each transform is a callable ``(image, bboxes, rng) -> (image, bboxes)``;
bboxes are (N, 5+) float arrays [x1, y1, x2, y2, class, (mixup weight)] in
absolute pixels, and ``rng`` is the sample's ``np.random.RandomState``.
The JAX package draws from the global ``np.random``; the legacy
``RandomState`` methods give the same draws from the same state, so with
one seed and one call order both chains give the same samples.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple, Union

import cv2
import numpy as np

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def fold_norm_affine(mean, std):
    """(x/255 - mean)/std == x*scale + bias, with the constants computed in
    numpy f32 exactly as the JAX package computes them: the one definition
    ``Normalize`` here and ``ops/preprocess.py::device_normalize`` share."""
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)
    return ((1.0 / (255.0 * std)).astype(np.float32),
            (-mean / std).astype(np.float32))


NORM_SCALE, NORM_BIAS = fold_norm_affine(IMAGENET_MEAN, IMAGENET_STD)

SizeT = Union[Tuple[int, int], Callable[[], Tuple[int, int]]]


def _get_size(size: SizeT) -> Tuple[int, int]:
    return size() if callable(size) else size


def filter_degenerate_boxes(original: np.ndarray, cropped: np.ndarray,
                            iou_threshold=0.3, area_threshold=56,
                            ratio_threshold=10) -> np.ndarray:
    """Drop boxes that a crop mangled: small area, extreme aspect ratio, or
    small survival fraction."""
    w = cropped[:, 2] - cropped[:, 0]
    h = cropped[:, 3] - cropped[:, 1]
    area = w * h
    area0 = (original[:, 2] - original[:, 0]) * (original[:, 3] - original[:, 1])
    aspect = np.maximum(w / (h + 1e-16), h / (w + 1e-16))
    keep = (area > area_threshold) & (area / (area0 + 1e-16) > iou_threshold) \
        & (aspect < ratio_threshold)
    return cropped[keep]


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img, bboxes, rng):
        for t in self.transforms:
            img, bboxes = t(img, bboxes, rng)
        return img, bboxes


class RandomCrop:
    """Fixed-size random crop, boxes clipped to it and the degenerate ones
    dropped."""

    def __init__(self, size: Tuple[int, int], p=0.5, iou_threshold=0.3,
                 area_threshold=56, ratio_threshold=10):
        self.size = size
        self.p = p
        self.filter_args = (iou_threshold, area_threshold, ratio_threshold)

    def __call__(self, img, bboxes, rng):
        if rng.random() > self.p:
            return img, bboxes
        h, w = img.shape[:2]
        ch, cw = self.size
        x0 = rng.randint(0, max(w - cw, 0) + 1)
        y0 = rng.randint(0, max(h - ch, 0) + 1)
        img = img[y0:min(y0 + ch, h), x0:min(x0 + cw, w), :]
        if len(bboxes) == 0:
            return img, bboxes
        new = bboxes.copy()
        new[:, [0, 2]] = np.clip(new[:, [0, 2]] - x0, 0, cw)
        new[:, [1, 3]] = np.clip(new[:, [1, 3]] - y0, 0, ch)
        return img, filter_degenerate_boxes(bboxes, new, *self.filter_args)


class RandomSafeCrop:
    """Random crop that never cuts into a GT box."""

    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, bboxes, rng):
        if rng.random() > self.p:
            return img, bboxes
        h, w = img.shape[:2]
        if len(bboxes) > 0:
            hull = np.round(np.concatenate([bboxes[:, :2].min(0),
                                            bboxes[:, 2:4].max(0)]))
        else:
            cx, cy = w // 2, h // 2
            hull = np.array([cx, cy, cx + 1, cy + 1])
        x0 = rng.randint(0, int(hull[0]) + 1)
        y0 = rng.randint(0, int(hull[1]) + 1)
        x1 = rng.randint(int(hull[2]), w + 1)
        y1 = rng.randint(int(hull[3]), h + 1)
        img = img[y0:y1, x0:x1, :]
        if len(bboxes) != 0:
            bboxes[:, [0, 2]] -= x0
            bboxes[:, [1, 3]] -= y0
        return img, bboxes


class RandomHFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, bboxes, rng):
        if rng.random() > self.p:
            return img, bboxes
        w = img.shape[1]
        img = img[:, ::-1, :]
        if len(bboxes) != 0:
            bboxes[:, [0, 2]] = w - bboxes[:, [2, 0]]
        return img, bboxes


class RandomVFlip:
    def __init__(self, p=0.5):
        self.p = p

    def __call__(self, img, bboxes, rng):
        if rng.random() > self.p:
            return img, bboxes
        h = img.shape[0]
        img = img[::-1, :, :]
        if len(bboxes) != 0:
            bboxes[:, [1, 3]] = h - bboxes[:, [3, 1]]
        return img, bboxes


class ColorJitter:
    """Brightness/contrast/saturation in random order (uint8 in/out)."""

    def __init__(self, brightness=(-0.1, 0.1), contrast=(0.8, 1.2),
                 saturation=(0.1, 2.0), p=1.0):
        self.brightness = brightness
        self.contrast = contrast
        self.saturation = saturation
        self.p = p

    def _brightness(self, img, rng):
        b = rng.uniform(*self.brightness) * 255
        return np.clip(img + round(b), 0, 255)

    def _contrast(self, img, rng):
        c = rng.uniform(*self.contrast)
        return np.clip(img * c, 0, 255).astype(np.int32)

    def _saturation(self, img, rng):
        gray = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_RGB2GRAY)
        s = rng.uniform(*self.saturation)
        return np.clip(s * img + (1 - s) * gray[..., None], 0, 255).astype(np.int32)

    def __call__(self, img, bboxes, rng):
        if rng.random() > self.p:
            return img, bboxes
        ops = [self._brightness, self._contrast, self._saturation]
        rng.shuffle(ops)
        img = img.astype(np.int32)
        for op in ops:
            img = op(img, rng)
        return img.astype(np.uint8), bboxes


class Normalize:
    """ImageNet normalization on the host (float32 out), with the folded
    affine of ``ops/preprocess.py``'s device normalize."""

    def __call__(self, img, bboxes, rng=None):
        img = img.astype(np.float32)  # always a fresh buffer -> in-place ok
        img *= NORM_SCALE
        img += NORM_BIAS
        return img, bboxes


class DeNormalize:
    """The inverse of ``Normalize``: float32 in, uint8 out (clipped)."""

    def __call__(self, img, bboxes, rng=None):
        std = np.asarray(IMAGENET_STD, np.float32)
        img = np.clip((img * std + np.asarray(IMAGENET_MEAN, np.float32)) * 255.0, 0, 255)
        return img.astype(np.uint8), bboxes


class Resize:
    """Letterbox: aspect-preserving resize + center pad to target size."""

    def __init__(self, size: SizeT, pad_val=128):
        self.size = size
        self.pad_val = pad_val

    def __call__(self, img, bboxes, rng=None):
        th, tw = _get_size(self.size)
        ih, iw = img.shape[:2]
        ratio = min(tw / iw, th / ih)
        rw, rh = round(ratio * iw), round(ratio * ih)
        img = cv2.resize(img, (rw, rh), interpolation=cv2.INTER_LINEAR)
        if (rw, rh) != (tw, th):
            dl = (tw - rw) // 2
            du = (th - rh) // 2
            canvas = np.full((th, tw) + img.shape[2:], self.pad_val, img.dtype)
            canvas[du:du + rh, dl:dl + rw] = img
            img = canvas
        else:
            dl = du = 0
        if len(bboxes) != 0:
            bboxes[:, [0, 2]] = bboxes[:, [0, 2]] * ratio + dl
            bboxes[:, [1, 3]] = bboxes[:, [1, 3]] * ratio + du
        return img, bboxes


class ResizeRatio:
    """Resize by a fixed ratio (one float, or (h, w) ratios), boxes scaled."""

    def __init__(self, ratio: Union[float, Tuple[float, float]]):
        self.ratio = (ratio, ratio) if np.isscalar(ratio) else tuple(ratio)

    def __call__(self, img, bboxes, rng=None):
        th = round(self.ratio[0] * img.shape[0])
        tw = round(self.ratio[1] * img.shape[1])
        img = cv2.resize(img, (tw, th), interpolation=cv2.INTER_LINEAR)
        if len(bboxes) != 0:
            bboxes[:, [0, 2]] *= self.ratio[1]
            bboxes[:, [1, 3]] *= self.ratio[0]
        return img, bboxes


class PadNearestDivisor:
    """Center-pad H and W up to the next multiple of ``divisor``."""

    def __init__(self, pad_val=128, divisor=32):
        self.pad_val = pad_val
        self.divisor = divisor

    def __call__(self, img, bboxes, rng=None):
        ih, iw = img.shape[:2]
        th = -(-ih // self.divisor) * self.divisor
        tw = -(-iw // self.divisor) * self.divisor
        dl = (tw - iw) // 2
        du = (th - ih) // 2
        img = np.pad(img, ((du, th - ih - du), (dl, tw - iw - dl), (0, 0)),
                     'constant', constant_values=self.pad_val)
        if len(bboxes) != 0:
            bboxes[:, [0, 2]] += dl
            bboxes[:, [1, 3]] += du
        return img, bboxes


class Mixup:
    """Beta-blend with a second sample from ``sampler(rng)``; appends the
    mixup weight as a bbox column."""

    def __init__(self, sampler: Callable, p=0.5, beta=1.0):
        self.sampler = sampler
        self.p = p
        self.beta = beta

    @staticmethod
    def _with_weight(bboxes, weight):
        if len(bboxes) == 0:
            return bboxes
        col = np.full((len(bboxes), 1), weight, np.float32)
        return np.concatenate([bboxes, col], axis=-1)

    def __call__(self, img, bboxes, rng):
        if rng.random() > self.p:
            return img, self._with_weight(bboxes, 1.0)
        img2, bboxes2 = self.sampler(rng)
        if img.shape != img2.shape:
            raise ValueError(f'mixup partners must share a shape, got '
                             f'{img.shape} vs {img2.shape}')
        lam = rng.beta(self.beta, self.beta)
        if img.dtype == np.uint8 and img2.dtype == np.uint8:
            img = cv2.addWeighted(img, lam, img2, 1.0 - lam, 0.0)
        else:
            img = lam * np.asarray(img, np.float32) \
                + (1 - lam) * np.asarray(img2, np.float32)
        parts = [b for b in (self._with_weight(bboxes, lam),
                             self._with_weight(bboxes2, 1 - lam)) if len(b)]
        if not parts:
            # both partners box-free: empty labels
            return img, np.zeros((0, 6), np.float32)
        return img, np.concatenate(parts)


class Mosaic:
    """4-image 2x2 mosaic cropped back to the target size; the three
    partners come from ``sampler(rng)``."""

    def __init__(self, sampler: Callable, size: SizeT, pad_val=128, p=1.0):
        self.sampler = sampler
        self.size = size
        self.pad_val = pad_val
        self.p = p

    def __call__(self, img, bboxes, rng):
        if rng.random() > self.p:
            return img, bboxes
        ih, iw = _get_size(self.size)
        xc = int(rng.uniform(iw * 0.5, iw * 1.5))
        yc = int(rng.uniform(ih * 0.5, ih * 1.5))
        # boxes are placed in the virtual (2ih, 2iw) mosaic frame; pixels
        # paste straight into the output window [ih/2:3ih/2, iw/2:3iw/2)
        wx0, wy0 = iw // 2, ih // 2
        canvas = np.full((ih, iw, 3), self.pad_val, np.uint8)

        others = [self.sampler(rng) for _ in range(3)]
        all_imgs = [(img, bboxes)] + list(others)
        originals = np.concatenate([b for _, b in all_imgs if len(b)] or
                                   [np.zeros((0, 5), np.float32)], axis=0)
        placed = []
        for i, (image, bbs) in enumerate(all_imgs):
            h, w = image.shape[:2]
            if i == 0:
                xa = (max(xc - w, 0), max(yc - h, 0), xc, yc)
                xb = (w - (xa[2] - xa[0]), h - (xa[3] - xa[1]), w, h)
            elif i == 1:
                xa = (xc, max(yc - h, 0), min(xc + w, iw * 2), yc)
                xb = (0, h - (xa[3] - xa[1]), min(w, xa[2] - xa[0]), h)
            elif i == 2:
                xa = (max(xc - w, 0), yc, xc, min(ih * 2, yc + h))
                xb = (w - (xa[2] - xa[0]), 0, max(xc, w), min(xa[3] - xa[1], h))
            else:
                xa = (xc, yc, min(xc + w, iw * 2), min(ih * 2, yc + h))
                xb = (0, 0, min(w, xa[2] - xa[0]), min(xa[3] - xa[1], h))
            dx0, dy0 = max(xa[0], wx0), max(xa[1], wy0)
            dx1, dy1 = min(xa[2], wx0 + iw), min(xa[3], wy0 + ih)
            if dx0 < dx1 and dy0 < dy1:
                sx0 = xb[0] + (dx0 - xa[0])
                sy0 = xb[1] + (dy0 - xa[1])
                canvas[dy0 - wy0:dy1 - wy0, dx0 - wx0:dx1 - wx0] = \
                    image[sy0:sy0 + (dy1 - dy0), sx0:sx0 + (dx1 - dx0)]
            if len(bbs):
                bbs = bbs.copy()
                bbs[:, [0, 2]] = np.clip(bbs[:, [0, 2]], xb[0], xb[2]) + xa[0] - xb[0]
                bbs[:, [1, 3]] = np.clip(bbs[:, [1, 3]], xb[1], xb[3]) + xa[1] - xb[1]
                placed.append(bbs)

        merged = np.concatenate(placed, axis=0) if placed \
            else np.zeros((0, 5), np.float32)
        if len(merged):
            merged[:, [0, 2]] = np.clip(merged[:, [0, 2]] - iw / 2, 0, iw)
            merged[:, [1, 3]] = np.clip(merged[:, [1, 3]] - ih / 2, 0, ih)
            merged = filter_degenerate_boxes(originals, merged,
                                             iou_threshold=0.2, area_threshold=25)
        return canvas, merged
