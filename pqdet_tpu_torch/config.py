"""Configuration: the defaults of ``pqdet_tpu/config.py`` that the port reads.

Plain dataclasses instead of the yaml-backed ``ConfigNode``; the attribute
paths (``cfg.dataset.name``, ``cfg.eval.input_size``, ``cfg.train.batch_size``
...) are the same, so the pipelines read both alike. The groups carry the
fields of the slices ported so far: serving (``dataset``, ``eval``) and the
training step (``model``, ``train``, ``system.compute_dtype``, ``sparse``).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import List, Tuple, Union

VOC_CLASSES = ['aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus',
               'car', 'cat', 'chair', 'cow', 'diningtable', 'dog', 'horse',
               'motorbike', 'person', 'pottedplant', 'sheep', 'sofa',
               'train', 'tvmonitor']


def _field(value):
    return dataclasses.field(default_factory=lambda: copy.deepcopy(value))


@dataclasses.dataclass
class SystemConfig:
    # bf16 conv compute (f32 accumulation, BN statistics and loss);
    # 'float32' for f32 throughout
    compute_dtype: str = 'bfloat16'


@dataclasses.dataclass
class DatasetConfig:
    name: str = 'voc'
    classes: List[str] = _field(VOC_CLASSES)


@dataclasses.dataclass
class ModelConfig:
    strides: List[int] = _field([8, 16, 32])
    gt_per_grid: int = 3
    anchors: List[List[int]] = _field([[10, 13], [16, 30], [33, 23], [30, 61], [62, 45],
                                       [59, 119], [116, 90], [156, 198], [373, 326]])
    anchors_iou_threshold: float = 0.3
    max_gt_boxes: int = 64         # static pad length of the GT boxes of a batch


@dataclasses.dataclass
class TrainConfig:
    input_sizes: List[int] = _field([320, 352, 384, 416, 448, 480, 512, 544, 576, 608])
    batch_size: int = 12
    scheduler: str = 'cosine'      # 'cosine' | 'step'
    learning_rate_init: float = 2e-4
    learning_rate_end: float = 1e-6
    weight_decay: float = 0.0      # L2 added to the gradient (not AdamW)
    grad_clip: float = 0.0         # global-norm clip, 0 = off
    # per-step max |activation| of each yolo head's input ('head_max')
    head_probe: bool = True
    mile_stones: List[int] = _field([30, 45])
    gamma: float = 0.1
    warmup_epochs: float = 1.0
    max_epochs: int = 80
    # activation recomputation for the backward pass: N >= 1 runs the walk
    # as N checkpointed segments; 0 = off
    remat: int = 0


@dataclasses.dataclass
class SparseConfig:
    switch: bool = False
    ratio: float = 0.01


@dataclasses.dataclass
class EvalConfig:
    input_size: Union[int, Tuple[int, int]] = 512
    score_threshold: float = 0.1
    iou_threshold: float = 0.45
    max_detections: int = 256      # static NMS output size
    # NMS candidate pool = max_detections * pool_factor top-scored
    # (box, class) pairs; NMSResult.overflow fires when more clear the
    # score threshold than the pool holds
    pool_factor: int = 4
    nms_method: str = 'nms'        # 'nms' | 'soft-nms'
    nms_sigma: float = 0.3         # gaussian decay for soft-nms
    # serve the inverted-residual chains through the fused CUDA kernel
    # (ops/fused_ir.py) instead of the layer walk
    fused_ir: bool = False


@dataclasses.dataclass
class Config:
    system: SystemConfig = dataclasses.field(default_factory=SystemConfig)
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    sparse: SparseConfig = dataclasses.field(default_factory=SparseConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)


def size_fix(size):
    """int -> (size, size); pairs pass through."""
    if isinstance(size, int):
        return (size, size)
    return tuple(size)
