"""Training data: the epoch plan, samples and the thread loader (the port of
``pqdet_tpu/data/train_data.py``, device-label mode).

The epoch plan is the JAX package's: ``random.Random(system.seed)`` draws
the sample indices with replacement and one input size per batch from
``train.input_sizes``, and the first batch takes the largest size (the
memory high-water mark first). So one config gives both packages the same
plan. Batches carry uint8 images and the GT boxes zero-padded to
``model.max_gt_boxes``; the label grids are built in the step
(``ops/labels.py``). With ``augment.device`` the host only letterboxes
and the GT rows carry a mixup weight of 1.

Each sample augments with its own ``np.random.RandomState``, seeded from
``(system.seed, epoch, slot)`` where the slot is the sample's place in the
epoch, so a batch does not depend on ``system.num_workers`` or on thread
timing; the JAX package draws every sample from the global ``np.random``
and its mixup and mosaic partners' paths from the global ``random``.
"""

from __future__ import annotations

import random
import threading
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from math import ceil
from typing import Iterator, List

import numpy as np

from pqdet_tpu_torch.config import later, sizes_fix
from pqdet_tpu_torch.data.samples import sample_getter


class TrainData:
    """Epoch-planned training data source (one sample at a time)."""

    def __init__(self, config):
        mode = config.system.label_assign
        if config.augment.device and mode != 'device':
            raise ValueError("augment.device=on needs system.label_assign='device': the "
                             'host assigner cannot see boxes transformed on device')
        if mode == 'host':
            raise later("system.label_assign='host'",
                        'queue 1, item 3 (host label assignment)')
        if mode != 'device':
            raise ValueError(f"system.label_assign must be 'device', got {mode!r}")
        self._input_sizes = sizes_fix(config.train.input_sizes)
        self._batch_size = config.train.batch_size
        self._max_gt = config.model.max_gt_boxes
        self._seed = config.system.seed
        self._plan_rng = random.Random(self._seed)
        self._epoch = -1
        self._warned_truncate = False

        with open(config.dataset.train_txt_file, 'r') as fr:
            self._imgs = [line.strip() for line in fr if line.strip()]
        self._num_imgs = len(self._imgs)
        # per-thread current input size: batches at different sizes may
        # assemble concurrently in the loader
        self._tls = threading.local()

        self.sample_getter = sample_getter(
            config.dataset.name, mode='train', classes=list(config.dataset.classes),
            cache_images=config.dataset.cache_images,
        ).set_train_augment(config.augment, self._current_input_size, self._sample_img_path)
        self.init_shuffle()

    @property
    def length(self):
        return self._num_imgs

    @property
    def batches_per_epoch(self):
        return ceil(self._num_imgs / self._batch_size)

    def __len__(self):
        return self._length

    def init_shuffle(self):
        """Plan the next epoch: sample indices and one size per batch."""
        self._epoch += 1
        n_batches = self.batches_per_epoch
        self._length = n_batches * self._batch_size
        self._indexes = self._plan_rng.choices(range(self._num_imgs), k=self._length)
        self._sizes = self._plan_rng.choices(self._input_sizes, k=n_batches)
        self._sizes[0] = max(self._input_sizes, key=lambda hw: hw[0] * hw[1])

    def _current_input_size(self):
        return self._tls.input_size

    def _sample_img_path(self, rng):
        return self._imgs[rng.randint(0, self._num_imgs)]

    def sample_rng(self, index: int) -> np.random.RandomState:
        """The augment generator of slot ``index`` of this epoch."""
        return np.random.RandomState([self._seed, self._epoch, index])

    def build_sample(self, img_index: int, size, rng):
        """Decode and augment one image-list entry at ``size``: (uint8 HWC
        image, (max_gt, 6) zero-padded GT boxes)."""
        self._tls.input_size = size
        image, bboxes = self.sample_getter(self._imgs[img_index], rng)
        bboxes = np.asarray(bboxes, np.float32)
        if len(bboxes) and bboxes.shape[-1] == 5:
            # the device chain's host part has no Mixup, the producer of the
            # weight column: weights start at 1 (the step sets them again)
            bboxes = np.concatenate([bboxes, np.ones((len(bboxes), 1), np.float32)], -1)
        bboxes = bboxes.reshape(-1, 6) if len(bboxes) else np.zeros((0, 6), np.float32)
        gt = np.zeros((self._max_gt, 6), np.float32)
        n = min(len(bboxes), self._max_gt)
        gt[:n] = bboxes[:n]
        if len(bboxes) > self._max_gt and not self._warned_truncate:
            self._warned_truncate = True
            warnings.warn(f'GT boxes exceeded model.max_gt_boxes={self._max_gt} and were '
                          'dropped; raise model.max_gt_boxes for crowded datasets '
                          '(warned once)', stacklevel=2)
        return image, gt

    def get(self, index: int):
        """Slot ``index`` of this epoch at its batch's planned size."""
        size = self._sizes[index // self._batch_size]
        return self.build_sample(self._indexes[index], size, self.sample_rng(index))

    def batch_indices(self) -> List[List[int]]:
        b = self._batch_size
        return [list(range(i * b, (i + 1) * b)) for i in range(self.batches_per_epoch)]


def make_batch(data: TrainData, indices: List[int], pool=None) -> dict:
    """One batch: {'image': (B, H, W, 3) uint8, 'gt': (B, max_gt, 6) f32}."""
    samples = list(pool.map(data.get, indices)) if pool is not None \
        else [data.get(i) for i in indices]
    return {'image': np.stack([s[0] for s in samples]),
            'gt': np.stack([s[1] for s in samples])}


def epoch_batches(data: TrainData, num_workers: int = 4,
                  prefetch: int = 2) -> Iterator[dict]:
    """One epoch of host batches: samples decode and augment in a pool of
    ``num_workers`` threads (cv2 and numpy release the GIL) while an
    assembly pool keeps ``prefetch`` batches in flight ahead of the
    consumer."""
    samples = ThreadPoolExecutor(max_workers=max(num_workers, 1))
    assembler = ThreadPoolExecutor(max_workers=max(prefetch, 1))
    try:
        pending = deque()
        for idx_list in data.batch_indices():
            while len(pending) >= max(prefetch, 1):
                yield pending.popleft().result()
            pending.append(assembler.submit(make_batch, data, idx_list, samples))
        while pending:
            yield pending.popleft().result()
    finally:
        assembler.shutdown(wait=False, cancel_futures=True)
        samples.shutdown(wait=False, cancel_futures=True)
