"""Classifier cfg generators (reference model/cfg/classifier/*.cfg); the
port's copy of ``pqdet_tpu/zoo/classifier.py``.

The reference ships backbone-pretraining classifier architectures as cfg
files: regnetx-600m / regnety-400m (backbone + avgpool + fc 1000) and a
torchvision-style ResNet-50 (stride-2 on the 3x3, projection on every
stage's first block). `resnet50-1g.cfg` is a slimming-pruner ARTIFACT
(irregular per-layer widths pruned to a 1-GFLOP budget) — that capability
lives in `compress/prune.py` (the cfg text of a pruned graph), not in the
zoo.

These build ClassifierNetwork graphs (no yolo heads): the executor applies
the fc after global avgpool (model/network.py, reference
interpreter.py:87 ClassifierModel).
"""

from __future__ import annotations

from typing import Optional

from pqdet_tpu_torch.zoo.builder import CfgBuilder
from pqdet_tpu_torch.zoo.regnet import REGNETX_600M, REGNETY_400M, _backbone

# ResNet-50: (inner width, out width, blocks) per stage
RESNET50_STAGES = [(64, 256, 3), (128, 512, 4), (256, 1024, 6),
                   (512, 2048, 3)]


def _res_bottleneck(b: CfgBuilder, inner: int, out_ch: int, stride: int,
                    project: bool) -> int:
    """One ResNet bottleneck (reference classifier/resnet50.cfg blocks:
    projection 1x1 linear at the block input when shape changes, body
    1x1 relu / 3x3 relu (carries the stride) / 1x1 linear, relu add)."""
    proj = None
    if project:
        proj = b.conv(out_ch, size=1, stride=stride, activation='linear',
                      comment='projection')
        b.route(proj - 1)
    block_in = proj if proj is not None else b.index
    b.conv(inner, size=1, activation='relu')
    b.conv(inner, size=3, stride=stride, activation='relu')
    b.conv(out_ch, size=1, activation='linear')
    return b.shortcut(block_in, activation='relu')


def resnet50(num_classes: int = 1000) -> str:
    """Torchvision-layout ResNet-50 (reference classifier/resnet50.cfg:
    7x7/2 stem, 3x3/2 maxpool, stages 3-4-6-3, stride-2 on the 3x3)."""
    b = CfgBuilder()
    b.conv(64, size=7, stride=2, activation='relu', comment='stem')
    b.maxpool(3, 2)
    for stage, (inner, out_ch, blocks) in enumerate(RESNET50_STAGES):
        for i in range(blocks):
            stride = 2 if (i == 0 and stage > 0) else 1
            _res_bottleneck(b, inner, out_ch, stride, project=(i == 0))
    b.avgpool()
    b.fc(RESNET50_STAGES[-1][1], num_classes)
    return b.text()


def _regnet_classifier(spec: dict, se_ratio: Optional[float],
                       num_classes: int) -> str:
    b = CfgBuilder()
    _, out_ch = _backbone(b, spec, se_ratio)
    b.avgpool()
    b.fc(out_ch, num_classes)
    return b.text()


def regnetx_600m(num_classes: int = 1000) -> str:
    return _regnet_classifier(REGNETX_600M, None, num_classes)


def regnety_400m(num_classes: int = 1000) -> str:
    return _regnet_classifier(REGNETY_400M, 0.25, num_classes)
