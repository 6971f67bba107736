"""Evaluation data: batches of preprocessed images and their GT (the port of
``pqdet_tpu/data/eval_data.py``). The last, ragged batch is zero-padded
to the full batch size so that the forward sees one shape; ``count``
marks the real rows. A dataset whose eval chain keeps each image's size
(VisDrone's) evaluates at batch 1, and its batches differ in shape."""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from math import ceil
from typing import Iterator, Optional

import numpy as np

from pqdet_tpu_torch.config import size_fix
from pqdet_tpu_torch.data.samples import sample_getter


class EvalData:

    def __init__(self, config):
        self._batch_size = config.eval.batch_size
        self._input_size = size_fix(config.eval.input_size)
        self.sample_getter = sample_getter(
            config.dataset.name, mode='eval', classes=list(config.dataset.classes),
        ).set_eval_augment(self._input_size, normalize=config.eval.host_normalize)

        with open(config.dataset.eval_txt_file, 'r') as fr:
            imgs = [line.strip() for line in fr if line.strip()]
        partial = config.eval.partial
        self._imgs = imgs[:partial] if partial else imgs
        self._num_imgs = len(self._imgs)

    @property
    def length(self):
        return self._num_imgs

    @property
    def input_size(self):
        """``eval.input_size`` as (h, w)."""
        return self._input_size

    def __len__(self):
        return ceil(self._num_imgs / self._batch_size)

    def batch(self, index: int, pool: Optional[ThreadPoolExecutor] = None) -> dict:
        start = index * self._batch_size
        end = min(self._num_imgs, start + self._batch_size)
        paths = self._imgs[start:end]
        samples = list(pool.map(self.sample_getter, paths)) if pool \
            else [self.sample_getter(p) for p in paths]

        # uint8 stays uint8 (normalized on the device); host-normalized
        # chains (eval.host_normalize) stay float32
        images = np.stack([s[0] for s in samples])
        shapes = np.stack([s[2] for s in samples])
        count = len(samples)
        if count < self._batch_size:
            pad = self._batch_size - count
            images = np.concatenate([images, np.zeros((pad,) + images.shape[1:],
                                                      images.dtype)])
            shapes = np.concatenate([shapes, np.ones((pad, 2), np.float32)])
        return {
            'image': images,
            'file_name': [s[1] for s in samples],
            'shape': shapes,
            'bboxes': [s[3] for s in samples],
            'difficult': [s[4] for s in samples],
            'count': count,
        }

    def batches(self, num_workers: int = 4, prefetch: int = 2) -> Iterator[dict]:
        with ThreadPoolExecutor(max_workers=max(num_workers, 1)) as samples, \
                ThreadPoolExecutor(max_workers=max(prefetch, 1)) as assembler:
            pending = deque()
            for i in range(len(self)):
                while len(pending) >= max(prefetch, 1):
                    yield pending.popleft().result()
                pending.append(assembler.submit(self.batch, i, samples))
            while pending:
                yield pending.popleft().result()
