"""The per-dataset sample getters (the port of ``pqdet_tpu/data/samples.py``):
each parses a dataset's labels and wires its train and eval augment chains.

- VOC: per-image XML under ``Annotations/`` beside ``JPEGImages/``, the
  difficult flag honoured. The annotation of ``.../JPEGImages/<stem>.<ext>``
  is ``.../Annotations/<stem>.xml`` for any image extension; the JAX getter
  replaces only ``.jpg``, as it does for the other two.
- COCO: darknet txt under ``labels/`` beside ``images/``, one normalized
  ``class cx cy w h`` line per box, made absolute by the image's size in
  ``base_train`` and ``eval``.
- VisDrone: comma lines ``x,y,w,h,score,category,truncation,occlusion``
  under ``annotations/`` beside ``images/``; categories 0 (ignored
  regions) and 11 (others) are dropped, score 0 marks a box difficult and
  train mode drops it. Its train chain is its own (a 416 random crop, the
  flips, colour jitter, letterbox) and its eval chain keeps each image's
  size: resize by 1.25, pad to a multiple of 32.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence
from xml.etree.ElementTree import parse as xml_parse

import cv2
import numpy as np

from pqdet_tpu_torch.data import augment


class BaseSampleGetter:
    """Loads (image, labels) by image path; mode 'train' or 'eval'. Train
    samples take the sample's ``np.random.RandomState``."""

    def __init__(self, mode: str = 'train',
                 classes: Optional[Sequence[str]] = None,
                 cache_images: bool = False):
        self.mode = mode
        self.cls_to_idx = {c: i for i, c in enumerate(classes)} if classes else None
        self.train_augment = augment.Compose([])
        self.eval_augment = augment.Compose([])
        self.compose_augment = None
        # dataset.cache_images: decoded RGB arrays and parsed labels stay in
        # RAM; copies go out, since the augment chain writes boxes in place
        self._img_cache = {} if cache_images else None
        self._label_cache = {} if cache_images else None

    def __call__(self, img_path: str, rng=None):
        return self.train(img_path, rng) if self.is_train else self.eval(img_path)

    @property
    def is_train(self):
        return self.mode == 'train'

    @staticmethod
    def _decode(img_path: str) -> np.ndarray:
        img = cv2.imread(img_path)
        if img is None:
            raise FileNotFoundError(f'image not found: {img_path}')
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def image(self, img_path: str) -> np.ndarray:
        if self._img_cache is None:
            return self._decode(img_path)
        img = self._img_cache.get(img_path)
        if img is None:
            img = self._img_cache[img_path] = self._decode(img_path)
        return img.copy()

    @staticmethod
    def shape(image: np.ndarray) -> np.ndarray:
        return np.array(image.shape[:2], np.float32)  # (h, w)

    def label(self, img_path: str):
        raise NotImplementedError

    def _cached_label(self, img_path: str):
        if self._label_cache is None:
            return self.label(img_path)
        lab = self._label_cache.get(img_path)
        if lab is None:
            lab = self._label_cache[img_path] = self.label(img_path)
        return lab.copy()

    def base_train(self, img_path: str, rng):
        image = self.image(img_path)
        bboxes = self._cached_label(img_path)
        return self.train_augment(image, bboxes, rng)

    def train(self, img_path: str, rng):
        image, bboxes = self.base_train(img_path, rng)
        if self.compose_augment is not None:
            image, bboxes = self.compose_augment(image, bboxes, rng)
        return image, bboxes

    def eval(self, img_path: str):
        image = self.image(img_path)
        shape = self.shape(image)
        image, _ = self.eval_augment(image, [], None)
        bboxes, diffs = self.label(img_path)
        return image, os.path.basename(img_path), shape, bboxes, diffs

    def train_chain(self, augment_cfg, input_size):
        """The per-sample train chain: the standard one (VOC's and COCO's)."""
        return _standard_train_chain(augment_cfg, input_size)

    def set_train_augment(self, augment_cfg, input_size, img_path_sampler):
        """The train chain, then the compose stage; ``img_path_sampler(rng)``
        draws a mixup or mosaic partner's path."""
        self.train_augment = self.train_chain(augment_cfg, input_size)
        sampler = lambda rng: self.base_train(img_path_sampler(rng), rng)  # noqa: E731
        self.compose_augment = augment.Compose(
            _compose_chain(augment_cfg, sampler, input_size))
        return self


def _standard_train_chain(augment_cfg, input_size):
    """The host chain; images stay uint8 (normalized on the device). With
    ``augment.device`` every stochastic transform runs in the step
    (``ops/augment_device.py``) and the host only letterboxes."""
    if augment_cfg.device:
        return augment.Compose([augment.Resize(input_size)])
    return augment.Compose([
        augment.RandomHFlip(p=augment_cfg.hflip_p),
        augment.RandomVFlip(p=augment_cfg.vflip_p),
        augment.RandomSafeCrop(p=augment_cfg.crop_p),
        augment.ColorJitter(p=augment_cfg.color_p),
        augment.Resize(input_size),
    ])


def _compose_chain(augment_cfg, sampler, input_size):
    """[Mosaic ->] Mixup, the compose stage; both blend uint8. Empty with
    ``augment.device`` (mosaic and mixup run in the step)."""
    if augment_cfg.device:
        return []
    chain = []
    if augment_cfg.mosaic_p > 0:
        chain.append(augment.Mosaic(sampler, size=input_size, p=augment_cfg.mosaic_p))
    chain.append(augment.Mixup(sampler, p=augment_cfg.mixup_p, beta=1.5))
    return chain


def _label_path(img_path: str, images: str, labels: str, ext: str) -> str:
    return os.path.splitext(img_path.replace(images, labels))[0] + ext


def annotation_path(img_path: str) -> str:
    """``.../JPEGImages/<stem>.<ext>`` -> ``.../Annotations/<stem>.xml``."""
    return _label_path(img_path, 'JPEGImages', 'Annotations', '.xml')


class VOCSampleGetter(BaseSampleGetter):

    def label(self, img_path: str):
        root = xml_parse(annotation_path(img_path)).getroot()
        bbs, diffs = [], []
        for obj in root.findall('object'):
            diff = int(obj.find('difficult').text)
            if self.is_train and diff == 1:
                continue
            cls_idx = self.cls_to_idx[obj.find('name').text]
            bb = obj.find('bndbox')
            bbs.append([float(bb.find(k).text) for k in
                        ('xmin', 'ymin', 'xmax', 'ymax')] + [cls_idx])
            diffs.append(diff)
        bbs = np.array(bbs, np.float32).reshape(-1, 5)
        if self.is_train:
            return bbs
        return bbs, np.array(diffs)

    def set_eval_augment(self, input_size, normalize=False):
        self.eval_augment = eval_augment_voc(input_size, normalize)
        return self


def eval_augment_voc(input_size, normalize=False):
    """Eval preprocessing: letterbox, uint8 out (normalized on the device);
    ``normalize`` normalizes on the host instead (float32 out)."""
    chain = [augment.Resize(input_size)]
    if normalize:
        chain.append(augment.Normalize())
    return augment.Compose(chain)


class COCOSampleGetter(BaseSampleGetter):

    def label(self, img_path: str):
        bbs = []
        with open(_label_path(img_path, 'images', 'labels', '.txt'), 'r') as fr:
            for line in fr:
                parts = line.split()
                if not parts:
                    continue
                cls_idx = int(parts[0])
                cx, cy, w, h = map(float, parts[1:5])
                bbs.append([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2, cls_idx])
        bbs = np.array(bbs, np.float32).reshape(-1, 5)
        if self.is_train:
            return bbs
        return bbs, np.zeros(len(bbs))

    @staticmethod
    def to_absolute(bboxes, shape):
        """Normalized boxes -> pixels of an image of ``shape`` (h, w)."""
        bboxes[:, :4] *= np.tile(shape[[1, 0]], 2)
        return bboxes

    def base_train(self, img_path: str, rng):
        image = self.image(img_path)
        bboxes = self.to_absolute(self._cached_label(img_path), self.shape(image))
        return self.train_augment(image, bboxes, rng)

    def set_eval_augment(self, input_size, normalize=False):
        self.eval_augment = eval_augment_coco(input_size, normalize)
        return self

    def eval(self, img_path: str):
        image = self.image(img_path)
        shape = self.shape(image)
        bboxes, diffs = self.label(img_path)
        bboxes = self.to_absolute(bboxes, shape)
        image, _ = self.eval_augment(image, [], None)
        return image, os.path.basename(img_path), shape, bboxes, diffs


eval_augment_coco = eval_augment_voc


class VisDroneSampleGetter(BaseSampleGetter):

    def label(self, img_path: str):
        bbs, diffs = [], []
        with open(_label_path(img_path, 'images', 'annotations', '.txt'), 'r') as fr:
            for line in fr:
                ann = line.split(',')
                if len(ann) < 6 or int(ann[5]) in (0, 11):
                    continue        # ignored regions, others
                diff = 0 if int(ann[4]) == 1 else 1
                if self.is_train and diff == 1:
                    continue
                x, y, w, h = (int(ann[i]) for i in range(4))
                bbs.append([float(x), float(y), float(x + w), float(y + h), int(ann[5]) - 1])
                diffs.append(diff)
        bbs = np.array(bbs, np.float32).reshape(-1, 5)
        if self.is_train:
            return bbs
        return bbs, np.array(diffs)

    def train_chain(self, augment_cfg, input_size):
        """VisDrone's own chain, with or without ``augment.device`` (as in
        the JAX package)."""
        return augment.Compose([
            augment.RandomCrop((416, 416), p=1.0),
            augment.RandomHFlip(p=augment_cfg.hflip_p),
            augment.RandomVFlip(p=augment_cfg.vflip_p),
            augment.ColorJitter(p=augment_cfg.color_p),
            augment.Resize(input_size),
        ])

    def set_eval_augment(self, input_size, normalize=False):
        self.eval_augment = eval_augment_visdrone(input_size, normalize)
        return self


def eval_augment_visdrone(_input_size, normalize=False):
    """Per-image sizes: resize by 1.25, pad to a multiple of 32 (the input
    size is not read)."""
    chain = [augment.ResizeRatio(1.25), augment.PadNearestDivisor()]
    if normalize:
        chain.append(augment.Normalize())
    return augment.Compose(chain)


SAMPLE_GETTER_REGISTER = {
    'voc': VOCSampleGetter,
    'coco': COCOSampleGetter,
    'visdrone': VisDroneSampleGetter,
}
EVAL_AUGMENT_REGISTER = {
    'voc': eval_augment_voc,
    'coco': eval_augment_coco,
    'visdrone': eval_augment_visdrone,
}


def sample_getter(name: str, **kwargs) -> BaseSampleGetter:
    """The getter of dataset ``name`` (voc, coco or visdrone, any case)."""
    return SAMPLE_GETTER_REGISTER[name.lower()](**kwargs)
