"""Serving configuration: the eval defaults of ``pqdet_tpu/config.py``.

Plain dataclasses instead of the yaml-backed ``ConfigNode``; the attribute
paths (``cfg.dataset.name``, ``cfg.eval.input_size`` ...) are the same, so
the predict pipeline reads both alike.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union


@dataclasses.dataclass
class DatasetConfig:
    name: str = 'voc'


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
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)


def size_fix(size):
    """int -> (size, size); pairs pass through."""
    if isinstance(size, int):
        return (size, size)
    return tuple(size)
