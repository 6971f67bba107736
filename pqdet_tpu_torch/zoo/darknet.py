"""YOLOv3 with its Darknet-53 backbone (Redmon & Farhadi, "YOLOv3: An
Incremental Improvement", arXiv:1804.02767), the layer graph of darknet's
``cfg/yolov3.cfg`` in PQDet's cfg dialect.

- Backbone: a 3x3/32 stem at stride 1, then five stages, each a stride-2
  3x3 followed by 1, 2, 8, 8 and 4 residual blocks of widths 64, 128, 256,
  512 and 1024. A block is a 1x1 to C/2, a 3x3 back to C and a linear
  shortcut.
- Head: three scales at strides 32, 16 and 8. Each runs five convs
  alternating 1x1 and 3x3 (1x1 widths 512, 256 and 128), a 3x3 at twice
  that width and a 1x1 prediction conv with no BN. A lateral takes the
  fifth conv (``route -4``) through a 1x1 at half its width and an
  upsample, and concatenates the backbone's stride-16 or stride-8 output.
- Leaky ReLU 0.1 everywhere but the prediction convs.

107 layers: 75 convs, 23 shortcuts, 4 routes, 2 upsamples, 3 yolo heads;
61,949,149 parameters at 80 classes. The ``[yolo]`` sections carry PQDet's
keys (classes and the loss's), not darknet's anchors and masks: the
anchors come from the config, and PQDet decodes boxes as ltrb distances.
This generator has no counterpart in the JAX package.
"""

from __future__ import annotations

from pqdet_tpu_torch.zoo.builder import CfgBuilder

DARKNET53_STAGES = ((64, 1), (128, 2), (256, 8), (512, 8), (1024, 4))
ACT = 'leaky'
ANCHORS_PER_CELL = 3


def _darknet53(b: CfgBuilder):
    """Emit the backbone; returns the layer indices of the stride-8 and
    stride-16 outputs (the head's route targets, darknet's 36 and 61)."""
    b.conv(32, size=3, activation=ACT, comment='stem')
    taps = []
    for width, blocks in DARKNET53_STAGES:
        b.conv(width, size=3, stride=2, activation=ACT, comment=f'downsample to {width}')
        for _ in range(blocks):
            block_in = b.index
            b.conv(width // 2, size=1, activation=ACT)
            b.conv(width, size=3, activation=ACT)
            b.shortcut(block_in)
        taps.append(b.index)
    return taps[2], taps[3]


def _head_scale(b: CfgBuilder, width: int, num_classes: int) -> int:
    """Five convs alternating 1x1 ``width`` and 3x3 2*``width``, a 3x3 at
    2*``width``, the prediction conv and the yolo layer; returns the fifth
    conv (the lateral's ``route -4``)."""
    for _ in range(2):
        b.conv(width, size=1, activation=ACT)
        b.conv(width * 2, size=3, activation=ACT)
    tap = b.conv(width, size=1, activation=ACT)
    b.conv(width * 2, size=3, activation=ACT)
    b.conv(ANCHORS_PER_CELL * (5 + num_classes), size=1, bn=False, activation='linear')
    b.yolo(num_classes)
    return tap


def yolov3(num_classes: int = 80) -> str:
    """cfg text of YOLOv3 (Darknet-53) with ``num_classes`` classes."""
    b = CfgBuilder()
    tap8, tap16 = _darknet53(b)
    tap = _head_scale(b, 512, num_classes)
    for width, lateral in ((256, tap16), (128, tap8)):
        b.route(tap)
        b.conv(width, size=1, activation=ACT)
        up = b.upsample()
        b.route([up, lateral])
        tap = _head_scale(b, width, num_classes)
    return b.text()
