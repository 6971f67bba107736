"""Training data: the epoch plan, samples, host label assignment and the two
loaders (the port of ``pqdet_tpu/data/train_data.py``).

The epoch plan is the JAX package's: ``random.Random(system.seed)`` draws
the sample indices with replacement and one input size per group of
``train.unroll_steps`` batches (one per batch at 1) from
``train.input_sizes``, the epoch rounded up to whole groups, and the first
group takes the largest size (the memory high-water mark first). So one
config gives both packages the same plan. Batches carry uint8 images and either the GT boxes zero-padded to
``model.max_gt_boxes`` (``system.label_assign device``: the label grids
are built in the step, ``ops/labels.py``) or the grids themselves
(``host``: ``assign_labels`` here, the batch's ``targets``). With
``augment.device`` the host only letterboxes and the GT rows carry a
mixup weight of 1.

Each sample augments with its own ``np.random.RandomState``, seeded from
``(system.seed, epoch, slot)`` where the slot is the sample's place in the
epoch, so a batch does not depend on ``system.num_workers``, on thread
timing or on the loader; the JAX package draws every sample from the
global ``np.random`` (seeded per worker pid in its process loader) and its
mixup and mosaic partners' paths from the global ``random``.

Two loaders: ``epoch_batches`` (``system.loader thread``), a pool of
threads; ``ProcessLoader`` (``process``), a pool of spawned workers that
write each batch into a shared-memory slab, which the parent copies out.

Data parallelism (``parallel/mesh.py``): every rank draws the same plan,
and ``TrainData(num_hosts=W, host_id=r)`` loads only rank r's contiguous
slice, rows [r*B/W, (r+1)*B/W), of each global batch of B, as the JAX
package's multi-host loading does. The slots stay global, so rank r's rows
equal those rows of the one-process batch bit for bit on either loader.
"""

from __future__ import annotations

import os
import random
import threading
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from math import ceil
from typing import Iterator, List, Optional, Tuple

import numpy as np

from pqdet_tpu_torch.config import sizes_fix
from pqdet_tpu_torch.data.samples import sample_getter

LABEL_SMOOTHING = 0.01


def smooth_onehot(num_classes: int, index: int, deta: float = LABEL_SMOOTHING) -> np.ndarray:
    """The label-smoothed one-hot of class ``index``."""
    onehot = np.full(num_classes, deta / num_classes, np.float32)
    onehot[index] += 1.0 - deta
    return onehot


def assign_labels(bboxes: np.ndarray, input_size: Tuple[int, int], strides: np.ndarray,
                  anchors: np.ndarray, num_classes: int, gt_per_grid: int = 3,
                  iou_threshold: float = 0.3, max_gt: int = 64):
    """GT boxes -> per-scale grid labels and padded raw box lists, on the host.

    ``bboxes``: (N, 6) [x1, y1, x2, y2, class, mixup weight]. Returns the
    label grids, (H/s, W/s, A, 6+C) for each stride s, and the (max_gt, 4)
    boxes each scale assigned, zero-padded. Each box goes to the anchors at
    its centre cell whose IoU with it (centre-aligned) is over the
    threshold, or to its best anchor when none is; a later box overwrites
    an earlier one at the same (cell, anchor). Vectorised over boxes, the
    same grids as ``ops/labels.py::assign_labels_device`` builds in the
    step.
    """
    A = gt_per_grid
    S = len(strides)
    out_sizes = [(input_size[0] // s, input_size[1] // s) for s in strides]
    labels = [np.zeros((h, w, A, 6 + num_classes), np.float32) for h, w in out_sizes]
    for lab in labels:
        lab[..., -1] = 1.0  # default mixup weight

    bboxes = np.asarray(bboxes, np.float32).reshape(-1, 6)
    n = len(bboxes)
    padded = [np.zeros((max_gt, 4), np.float32) for _ in range(S)]
    if n == 0:
        return labels, padded

    coor = bboxes[:, :4]
    cls_idx = bboxes[:, 4].astype(np.int32)
    mixw = bboxes[:, 5]
    cxy = (coor[:, 2:] + coor[:, :2]) * 0.5
    wh = coor[:, 2:] - coor[:, :2]

    onehot = np.full((n, num_classes), LABEL_SMOOTHING / num_classes, np.float32)
    onehot[np.arange(n), cls_idx] += 1.0 - LABEL_SMOOTHING

    strides_f = np.asarray(strides, np.float32)
    xy_idx = np.floor(cxy[:, None, :] / strides_f[None, :, None]).astype(np.int32)  # (N, S, 2)
    centers = (xy_idx.astype(np.float32) + 0.5) * strides_f[None, :, None]

    # IoU(box, anchor at the centre cell), all (box, anchor) pairs at once
    a_cxy = np.repeat(centers, A, axis=1)                                          # (N, S*A, 2)
    a_wh = np.broadcast_to(np.asarray(anchors, np.float32)[None], (n, S * A, 2))
    b_min = cxy[:, None] - wh[:, None] * 0.5
    b_max = cxy[:, None] + wh[:, None] * 0.5
    a_min = a_cxy - a_wh * 0.5
    a_max = a_cxy + a_wh * 0.5
    inter = np.prod(np.clip(np.minimum(b_max, a_max) - np.maximum(b_min, a_min), 0, None),
                    axis=-1)
    union = (wh[:, 0] * wh[:, 1])[:, None] + a_wh[..., 0] * a_wh[..., 1] - inter
    ious = inter / np.maximum(union, 1e-12)                                        # (N, S*A)

    mask = ious > iou_threshold
    none_hit = ~mask.any(axis=1)
    mask[none_hit, ious[none_hit].argmax(axis=1)] = True

    entries = np.concatenate([coor, np.ones((n, 1), np.float32), onehot, mixw[:, None]],
                             axis=1)                                               # (N, 6+C)
    truncated = 0
    for s in range(S):
        h, w = out_sizes[s]
        x, y = xy_idx[:, s, 0], xy_idx[:, s, 1]
        in_bounds = (0 <= y) & (y < h) & (0 <= x) & (x < w)
        m = mask[:, s * A:(s + 1) * A] & in_bounds[:, None]                        # (N, A)
        bi, ai = np.nonzero(m)  # ascending box order: the last box wins a cell
        if len(bi):
            labels[s][y[bi], x[bi], ai] = entries[bi]
        hit = m.any(axis=1)
        nb = int(hit.sum())
        if nb:
            truncated += max(nb - max_gt, 0)
            keep = coor[hit][:max_gt]
            padded[s][:len(keep)] = keep
    if truncated:
        warnings.warn(f'GT boxes exceeded model.max_gt_boxes={max_gt} and were dropped from '
                      'the conf-loss ignore mask; raise model.max_gt_boxes for crowded '
                      'datasets', stacklevel=2)
    return labels, padded


class TrainData:
    """Epoch-planned training data source (one sample at a time); with
    ``num_hosts`` W > 1, host (rank) ``host_id``'s slice of each global
    batch (the module docstring)."""

    def __init__(self, config, num_hosts: int = 1, host_id: int = 0):
        mode = config.system.label_assign
        if mode not in ('device', 'host'):
            raise ValueError(f"system.label_assign must be 'device' or 'host', got {mode!r}")
        if config.augment.device and mode != 'device':
            raise ValueError("augment.device=on needs system.label_assign='device': the "
                             'host assigner cannot see boxes transformed on device')
        self._config = config       # the process loader's workers rebuild from it
        self._device_labels = mode == 'device'
        self._input_sizes = sizes_fix(config.train.input_sizes)
        self._batch_size = config.train.batch_size
        self._size_group = max(int(config.train.unroll_steps), 1)
        if self._batch_size % num_hosts:
            raise ValueError(f'train.batch_size={self._batch_size} must be divisible by '
                             f'num_hosts={num_hosts}')
        self._num_hosts = num_hosts
        self._host_id = host_id
        self._max_gt = config.model.max_gt_boxes
        self._strides = np.array(config.model.strides)
        self._anchors = np.array(config.model.anchors, np.float32)
        self._num_classes = len(config.dataset.classes)
        self._gt_per_grid = config.model.gt_per_grid
        self._iou_threshold = config.model.anchors_iou_threshold
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
        """Batches per epoch, rounded up to whole groups of
        ``train.unroll_steps`` same-size batches (the plan samples with
        replacement, so the extra batches are more samples)."""
        n = ceil(self._num_imgs / self._batch_size)
        return ceil(n / self._size_group) * self._size_group

    def __len__(self):
        return self._length

    def init_shuffle(self):
        """Plan the next epoch: sample indices and one size per group of
        ``train.unroll_steps`` batches (JAX's draws), the first group at the
        largest size."""
        self._epoch += 1
        n_batches = self.batches_per_epoch
        g = self._size_group
        self._length = n_batches * self._batch_size
        self._indexes = self._plan_rng.choices(range(self._num_imgs), k=self._length)
        group_sizes = self._plan_rng.choices(self._input_sizes, k=ceil(n_batches / g))
        self._sizes = [group_sizes[i // g] for i in range(n_batches)]
        largest = max(self._input_sizes, key=lambda hw: hw[0] * hw[1])
        for i in range(min(g, n_batches)):
            self._sizes[i] = largest

    def _current_input_size(self):
        return self._tls.input_size

    def _sample_img_path(self, rng):
        return self._imgs[rng.randint(0, self._num_imgs)]

    def sample_rng(self, index: int, epoch: Optional[int] = None) -> np.random.RandomState:
        """The augment generator of slot ``index`` of this epoch (or of
        ``epoch``)."""
        return np.random.RandomState([self._seed, self._epoch if epoch is None else epoch,
                                      index])

    def build_sample(self, img_index: int, size, rng):
        """Decode and augment one image-list entry at ``size``: (uint8 HWC
        image, (max_gt, 6) zero-padded GT boxes) with device labels, (image,
        3 label grids, 3 padded box lists) with host labels."""
        self._tls.input_size = size
        image, bboxes = self.sample_getter(self._imgs[img_index], rng)
        bboxes = np.asarray(bboxes, np.float32)
        if len(bboxes) and bboxes.shape[-1] == 5:
            # the device chain's host part has no Mixup, the producer of the
            # weight column: weights start at 1 (the step sets them again)
            bboxes = np.concatenate([bboxes, np.ones((len(bboxes), 1), np.float32)], -1)
        bboxes = bboxes.reshape(-1, 6) if len(bboxes) else np.zeros((0, 6), np.float32)
        if not self._device_labels:
            labels, padded = assign_labels(bboxes, size, self._strides, self._anchors,
                                           self._num_classes, self._gt_per_grid,
                                           self._iou_threshold, self._max_gt)
            return image, labels, padded
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

    @property
    def local_batch_size(self) -> int:
        """Rows of each global batch this host loads."""
        return self._batch_size // self._num_hosts

    def batch_indices(self) -> List[List[int]]:
        """This host's slots of each global batch (the whole batches on one
        host)."""
        b, lb = self._batch_size, self.local_batch_size
        lo = self._host_id * lb
        return [list(range(i * b + lo, i * b + lo + lb)) for i in range(self.batches_per_epoch)]


def make_batch(data: TrainData, indices: List[int], pool=None) -> dict:
    """One batch: {'image': (B, H, W, 3) uint8, 'gt': (B, max_gt, 6) f32}
    with device labels; {'image', 'targets': (3 label grids, 3 padded box
    lists), each stacked over B} with host labels."""
    samples = list(pool.map(data.get, indices)) if pool is not None \
        else [data.get(i) for i in indices]
    images = np.stack([s[0] for s in samples])
    if len(samples[0]) == 2:
        return {'image': images, 'gt': np.stack([s[1] for s in samples])}
    labels = [np.stack([s[1][k] for s in samples]) for k in range(3)]
    boxes = [np.stack([s[2][k] for s in samples]) for k in range(3)]
    return {'image': images, 'targets': tuple(labels + boxes)}


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


# ---------------------------------------------------------- the process loader

# the worker's TrainData, rebuilt from the config by _mp_init
_MP_DATA: Optional[TrainData] = None


def _mp_init(config):
    """Initializer of a spawned worker: no GPU (the worker never touches
    CUDA), cv2 single-threaded, and its own TrainData from the config."""
    global _MP_DATA
    os.environ['CUDA_VISIBLE_DEVICES'] = ''
    import cv2
    cv2.setNumThreads(0)
    _MP_DATA = TrainData(config)


def _batch_layout(data: TrainData, n: int, size):
    """[(shape, dtype, offset)] of one slab and its bytes: the uint8 images,
    then the GT boxes (device labels) or the 3 label grids and 3 box lists
    (host labels)."""
    h, w = size
    specs = [((n, h, w, 3), np.uint8)]
    if data._device_labels:
        specs.append(((n, data._max_gt, 6), np.float32))
    else:
        specs += [((n, h // s, w // s, data._gt_per_grid, 6 + data._num_classes), np.float32)
                  for s in data._strides]
        specs += [((n, data._max_gt, 4), np.float32)] * 3
    layout, off = [], 0
    for shape, dtype in specs:
        layout.append((shape, dtype, off))
        off += int(np.prod(shape)) * np.dtype(dtype).itemsize
    return layout, off


def _mp_build_batch(task):
    """(image-list indices, their slots, epoch, (h, w), slab name) -> None:
    each sample built with its slot's generator, as the thread loader
    builds it, and written into the shared-memory slab."""
    from multiprocessing import shared_memory
    img_indices, slots, epoch, size, slab_name = task
    d = _MP_DATA
    layout, _ = _batch_layout(d, len(img_indices), size)
    sm = shared_memory.SharedMemory(name=slab_name)
    try:
        arrays = [np.ndarray(shape, dtype, sm.buf, off) for shape, dtype, off in layout]
        for j, (i, slot) in enumerate(zip(img_indices, slots)):
            sample = d.build_sample(i, size, d.sample_rng(slot, epoch))
            if sample[0].dtype != np.uint8:
                raise TypeError('system.loader=process needs uint8 train images (normalized '
                                f'on the device), got {sample[0].dtype}')
            arrays[0][j] = sample[0]
            if d._device_labels:
                arrays[1][j] = sample[1]
            else:
                for k in range(3):
                    arrays[1 + k][j] = sample[1][k]
                    arrays[4 + k][j] = sample[2][k]
        del arrays
    finally:
        sm.close()


class ProcessLoader:
    """A persistent pool of spawned workers for the epochs of a TrainData.

    Per-sample Python (augment control flow, label assignment, small numpy
    ops) holds the GIL, so the thread loader stops scaling at a share of
    one core; processes do not. Batches travel through shared-memory slabs,
    one parent-side copy each (pickling a batch through the pipe costs
    more than the thread loader saves). The parent resolves every batch to
    (image indices, slots, size) from the epoch plan, and each sample draws
    from its slot's generator, so the batches equal the thread loader's bit
    for bit. The pool and the slabs live until ``close``; an abandoned
    epoch returns its slabs to the free list.
    """

    def __init__(self, data: TrainData, num_workers: int = 4, prefetch: int = 2):
        import multiprocessing as mp
        from multiprocessing import shared_memory
        self._data = data
        self._prefetch = max(prefetch, 1)
        biggest = max(data._input_sizes, key=lambda hw: hw[0] * hw[1])
        _, slab_bytes = _batch_layout(data, data.local_batch_size, biggest)
        self._slabs = {}
        try:
            for _ in range(self._prefetch + 2):
                sm = shared_memory.SharedMemory(create=True, size=slab_bytes)
                self._slabs[sm.name] = sm
            self._free = list(self._slabs)
            self._pool = mp.get_context('spawn').Pool(max(num_workers, 1), initializer=_mp_init,
                                                      initargs=(data._config,))
        except BaseException:
            self._unlink()
            raise

    @property
    def slab_names(self) -> List[str]:
        return list(self._slabs)

    def _copy_out(self, name: str, n: int, size) -> dict:
        buf = self._slabs[name].buf
        out = [np.ndarray(shape, dtype, buf, off).copy()
               for shape, dtype, off in _batch_layout(self._data, n, size)[0]]
        if self._data._device_labels:
            return {'image': out[0], 'gt': out[1]}
        return {'image': out[0], 'targets': tuple(out[1:])}

    def epoch(self) -> Iterator[dict]:
        """This epoch's batches, at most ``prefetch`` in flight."""
        data = self._data
        epoch = data._epoch
        tasks = iter([([data._indexes[i] for i in slots], slots, tuple(data._sizes[k]))
                      for k, slots in enumerate(data.batch_indices())])
        pending = deque()

        def submit(task):
            name = self._free.pop()
            indices, slots, size = task
            fut = self._pool.apply_async(_mp_build_batch,
                                         ((indices, slots, epoch, size, name),))
            pending.append((name, len(indices), size, fut))

        try:
            for task in (next(tasks, None) for _ in range(self._prefetch)):
                if task is not None:
                    submit(task)
            while pending:
                name, n, size, fut = pending.popleft()
                try:
                    fut.get()
                    batch = self._copy_out(name, n, size)
                finally:
                    self._free.append(name)
                task = next(tasks, None)
                if task is not None:
                    submit(task)
                yield batch
        finally:
            # an abandoned epoch (an exception in the step, an early break):
            # each slab in flight returns to the free list once its worker
            # is done writing it
            while pending:
                name, _, _, fut = pending.popleft()
                fut.wait(timeout=60)
                self._free.append(name)

    def _unlink(self):
        for sm in self._slabs.values():
            sm.close()
            try:
                sm.unlink()
            except FileNotFoundError:
                pass
        self._slabs = {}

    def close(self):
        """End the workers and free the slabs."""
        pool = getattr(self, '_pool', None)
        if pool is not None:
            pool.terminate()
            pool.join()
            self._pool = None
        self._unlink()
