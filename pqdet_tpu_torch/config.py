"""Configuration: the defaults of ``pqdet_tpu/config.py`` that the port reads.

Plain dataclasses instead of the yaml-backed ``ConfigNode``; the attribute
paths (``cfg.dataset.name``, ``cfg.eval.input_size``, ``cfg.train.batch_size``
...) are the same, so the pipelines read both alike. The groups carry the
fields of the slices ported so far: serving (``dataset``, ``eval``), the
training step (``model``, ``train``, ``system.compute_dtype``, ``sparse``) and
the trainer (``experiment_name``, ``weight``, ``augment``, the loaders'
``dataset``/``system`` fields, ``eval.after`` ...) QAT (``quant``) and pruning (``prune``).

``load_config(yaml_path, opts)`` merges a yaml file and a flat list of
dotted overrides into the defaults, typed by each field's default as the
JAX ``ConfigNode`` types them. A key of the JAX schema whose slice is not
ported yet raises ``NotImplementedError`` naming its ROADMAP item; any other
unknown key raises ``KeyError``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import yaml

VOC_CLASSES = ['aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus',
               'car', 'cat', 'chair', 'cow', 'diningtable', 'dog', 'horse',
               'motorbike', 'person', 'pottedplant', 'sheep', 'sofa',
               'train', 'tvmonitor']


def _field(value):
    return dataclasses.field(default_factory=lambda: copy.deepcopy(value))


@dataclasses.dataclass
class SystemConfig:
    # '' keeps the device the caller asks for (the CLIs' --device); 'cpu'
    # sends the CLIs and the Trainer to the CPU (JAX's key forces a JAX
    # platform; the port has the one choice, see platform_device)
    platform: str = ''
    # bf16 conv compute (f32 accumulation, BN statistics and loss);
    # 'float32' for f32 throughout
    compute_dtype: str = 'bfloat16'
    num_workers: int = 4           # host loader workers (decode and augment)
    # 'thread' (cv2 and numpy release the GIL) or 'process' (spawned workers
    # writing batches into shared-memory slabs; scales past the GIL)
    loader: str = 'thread'
    prefetch: int = 2              # batches assembled ahead of the consumer
    # uploaded batches kept ahead of the step by a background thread that
    # copies the next N to the device (0 = upload in the step loop)
    device_prefetch: int = 0
    # 'device': batches carry padded GT boxes, the label grids are built in
    # the step (ops/labels.py); 'host': the loader builds the grids
    # (data/train_data.py::assign_labels) and batches carry 'targets'
    label_assign: str = 'device'
    # seed of the epoch plan (sample indices, input sizes) and of each
    # sample's augment generator
    seed: int = 0
    # data-parallel ranks, one process each (parallel/mesh.py): on the card
    # GPUs, 0 = every visible one; on the CPU gloo processes, 0 = one;
    # capped by the largest count that divides train.batch_size. With
    # train.spatial N it is the total budget of n_data x N ranks
    data_devices: int = 0


@dataclasses.dataclass
class DatasetConfig:
    name: str = 'VOC'
    train_txt_file: str = ''
    eval_txt_file: str = ''
    classes: List[str] = _field(VOC_CLASSES)
    # keep decoded images (and parsed labels) in RAM, hand out copies
    cache_images: bool = False
    # the whole train split decoded and letterboxed once at the largest
    # train.input_sizes into one uint8 tensor on the card; steps gather
    # their rows there (needs augment.device)
    device_cache: bool = False


@dataclasses.dataclass
class ModelConfig:
    cfg_path: str = 'mobilenetv2-fpn'   # a .cfg path or a zoo model name
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
    # space-to-depth stem ingest in the step (see eval.s2d_stem); the fold
    # is differentiable, so the grads reach the stem's own kernel
    s2d_stem: int = 0
    # spatial partitioning: shard the image HEIGHT axis over this many
    # ranks (0/1 = off). The ranks form a (data x spatial) mesh and every
    # conv and max pool exchanges halo rows with its neighbours
    # (parallel/mesh.py make_mesh_2d, parallel/halo.py): the model-parallel
    # axis for very large inputs. Needs the default system.label_assign
    # device batch format; excludes dataset.device_cache and unroll_steps > 1.
    # An input height need not divide by the bands: the bands of a padded
    # image are walked and the padding is masked out (parallel/halo.py).
    spatial: int = 0
    # K train steps per dispatch (train/step.py make_multi_step) on K
    # same-size batches: the epoch plan draws one input size per group of K
    # batches and rounds the epoch up to whole groups
    unroll_steps: int = 1


@dataclasses.dataclass
class AugmentConfig:
    """The augment chain's probabilities (``data/augment.py`` on the host,
    ``ops/augment_device.py`` on the device)."""
    mixup_p: float = 0.5
    color_p: float = 0.0
    hflip_p: float = 0.5
    vflip_p: float = 0.0
    crop_p: float = 0.75
    mosaic_p: float = 0.0
    # the stochastic chain on the device, in the step (ops/augment_device.py);
    # the host only letterboxes
    device: bool = False
    # mosaic and mixup partners as fresh corpus rows of the device cache
    # instead of in-batch permutations: 'auto' (on exactly with
    # dataset.device_cache), 'on' (needs the cache) or 'off'
    fresh_partners: str = 'auto'


@dataclasses.dataclass
class WeightConfig:
    dir: str = 'weights'           # checkpoints go to <dir>/<experiment_name>/
    backbone: str = ''             # checkpoint whose layers seed the model
    resume: str = ''               # checkpoint to resume from
    clear_history: bool = False    # resume the weights but restart at step 0


@dataclasses.dataclass
class SparseConfig:
    switch: bool = False
    ratio: float = 0.01


@dataclasses.dataclass
class PruneConfig:
    weight: str = ''
    new_cfg: str = ''
    ratio: float = 0.3
    # fine-tune epochs after pruning (the JAX package's default)
    finetune_epochs: int = 20


@dataclasses.dataclass
class QuantConfig:
    switch: bool = False           # quantization-aware training (fake-quant int8)
    backend: str = 'int8'          # JAX's schema carries it; qat checkpoints name 'int8'
    # the observers update in epochs before this one, then freeze
    disable_observer_after: int = 4
    # BN runs on batch statistics in epochs before this one, then frozen
    freeze_bn_after: int = 8


@dataclasses.dataclass
class EvalConfig:
    after: int = 30                # first epoch that evaluates
    interval: int = 1              # then every Nth epoch (and the last)
    input_size: Union[int, Tuple[int, int]] = 512
    batch_size: int = 16
    partial: int = 0               # evaluate the first N images (0 = all)
    # normalize eval images on the host (float batches) instead of the device
    host_normalize: bool = False
    score_threshold: float = 0.1
    iou_threshold: float = 0.45
    map_iou: float = 0.5           # carried for the JAX schema; read by neither package
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
    # space-to-depth stem ingest factor of the default forward (0 = off; 2
    # folds the stride-2 stem onto an (H/2, W/2, 12) input, function-
    # preserving: ops/space_to_depth.py)
    s2d_stem: int = 0


@dataclasses.dataclass
class Config:
    experiment_name: str = 'VOC'
    system: SystemConfig = dataclasses.field(default_factory=SystemConfig)
    dataset: DatasetConfig = dataclasses.field(default_factory=DatasetConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    augment: AugmentConfig = dataclasses.field(default_factory=AugmentConfig)
    weight: WeightConfig = dataclasses.field(default_factory=WeightConfig)
    sparse: SparseConfig = dataclasses.field(default_factory=SparseConfig)
    prune: PruneConfig = dataclasses.field(default_factory=PruneConfig)
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)


# keys of the JAX schema whose slice of the port is still queued: none is
LATER_KEYS = {}


def later(what: str, item: str):
    """The error for a part of the JAX package whose slice is queued."""
    return NotImplementedError(f'{what}: not ported yet (ROADMAP.md {item})')


def _coerce(key: str, old, new):
    """``new`` as the type of the default ``old`` (the JAX ``ConfigNode``'s
    rules: yaml's on/off and strings for bools, ints for floats, numeric
    strings for numbers, sequences for lists)."""
    if old is None or new is None:
        return new
    if isinstance(old, bool):
        if isinstance(new, bool):
            return new
        if isinstance(new, str):
            low = new.lower()
            if low in ('true', 'on', 'yes', '1'):
                return True
            if low in ('false', 'off', 'no', '0'):
                return False
        if isinstance(new, int):
            return bool(new)
        raise TypeError(f'{key}: cannot interpret {new!r} as bool')
    if isinstance(old, float) and isinstance(new, int):
        return float(new)
    if isinstance(old, (int, float)) and isinstance(new, str):
        try:
            return type(old)(float(new) if '.' in new or 'e' in new.lower() else new)
        except ValueError:
            raise TypeError(f'{key}: cannot interpret {new!r} as {type(old).__name__}')
    if isinstance(old, (list, tuple)) and isinstance(new, (list, tuple)):
        return list(new)
    if isinstance(old, str) and isinstance(new, bool):
        return 'on' if new else 'off'
    if type(old) is not type(new) and not (
            isinstance(old, (int, float)) and isinstance(new, (int, float))):
        raise TypeError(
            f'{key}: type mismatch ({type(new).__name__} vs {type(old).__name__})')
    return new


def _check_known(node, key: str, leaf: str):
    if leaf not in {f.name for f in dataclasses.fields(node)}:
        group = key.split('.')[0]
        item = LATER_KEYS.get(key) or LATER_KEYS.get(group)
        if item:
            raise later(f'config key {key}', item)
        raise KeyError(f'unknown config key: {key}')


def merge_dict(cfg, data: Dict[str, Any], prefix: str = ''):
    """Merge a nested mapping (a parsed yaml file) into ``cfg`` in place."""
    for k, v in data.items():
        key = f'{prefix}{k}'
        _check_known(cfg, key, k)
        cur = getattr(cfg, k)
        if dataclasses.is_dataclass(cur):
            if not isinstance(v, dict):
                raise TypeError(f'{key}: expected a mapping')
            merge_dict(cur, v, key + '.')
        else:
            setattr(cfg, k, _coerce(key, cur, v))
    return cfg


def merge_from_list(cfg, opts: List[str]):
    """Merge a flat [key, value, key, value, ...] override list with dotted
    keys into ``cfg`` in place; string values are read as yaml scalars or
    flow lists."""
    if len(opts) % 2 != 0:
        raise ValueError('override list must have even length')
    for key, value in zip(opts[::2], opts[1::2]):
        node = cfg
        parts = key.split('.')
        for i, p in enumerate(parts[:-1]):
            _check_known(node, '.'.join(parts[:i + 1]), p)
            node = getattr(node, p)
            if not dataclasses.is_dataclass(node):
                raise KeyError(f'unknown config key: {key}')
        _check_known(node, key, parts[-1])
        if isinstance(value, str):
            try:
                value = yaml.safe_load(value)
            except yaml.YAMLError:
                pass
        setattr(node, parts[-1], _coerce(key, getattr(node, parts[-1]), value))
    return cfg


def load_config(yaml_path: Optional[str] = None, opts: Optional[List[str]] = None) -> Config:
    """The defaults, then the yaml file, then the overrides."""
    cfg = Config()
    if yaml_path:
        with open(yaml_path, 'r') as fr:
            merge_dict(cfg, yaml.safe_load(fr) or {})
    if opts:
        merge_from_list(cfg, list(opts))
    platform_device(cfg, None)      # an unknown system.platform raises here
    return cfg


PLATFORMS = ('', 'cpu')


def platform_device(cfg: Config, device):
    """The device a CLI or the Trainer runs on: the CPU when
    ``system.platform`` is 'cpu', else ``device``; any other platform
    raises."""
    if cfg.system.platform not in PLATFORMS:
        raise ValueError(f'system.platform: {cfg.system.platform!r} is not one of '
                         f'{PLATFORMS} (the port runs on the card or on the CPU)')
    return 'cpu' if cfg.system.platform == 'cpu' else device


def resolve_model_cfg(cfg: Config) -> str:
    """``model.cfg_path`` as cfg text: a zoo model name or a file path."""
    from pqdet_tpu_torch.zoo import MODEL_ZOO, get_cfg
    path = cfg.model.cfg_path
    if path in MODEL_ZOO:
        return get_cfg(path, num_classes=len(cfg.dataset.classes))
    with open(path, 'r') as fr:
        return fr.read()


def size_fix(size):
    """int -> (size, size); pairs pass through."""
    if isinstance(size, int):
        return (size, size)
    return tuple(size)


def sizes_fix(sizes):
    return [size_fix(s) for s in sizes]
