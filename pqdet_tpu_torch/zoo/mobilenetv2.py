"""MobileNetV2 backbone + depthwise-separable FPN head generator.

Backbone follows the published MobileNetV2 spec (Sandler et al. 2018,
inverted residual settings (t, c, n, s)); the three-scale YOLO-FPN head uses
three (1x1 C, dw3x3 C, 1x1 2C) bottleneck repeats per scale with lateral
1x1 + nearest-upsample merges, the same topology as the reference's
mobilenetv2-fpn.cfg model.
"""

from __future__ import annotations

from pqdet_tpu_torch.zoo.builder import CfgBuilder

# (expansion t, out channels c, repeats n, first stride s)
INVERTED_RESIDUAL_SETTINGS = [
    (1, 16, 1, 1),
    (6, 24, 2, 2),
    (6, 32, 3, 2),
    (6, 64, 4, 2),
    (6, 96, 3, 1),
    (6, 160, 3, 2),
    (6, 320, 1, 1),
]


def _inverted_residual(b: CfgBuilder, in_ch: int, out_ch: int, t: int,
                       stride: int, act: str) -> int:
    """Emit one inverted-residual block; returns the output layer index."""
    block_in = b.index
    expanded = in_ch * t
    if t != 1:
        b.conv(expanded, size=1, activation=act)
    b.conv(expanded, size=3, stride=stride, groups=expanded, activation=act)
    out = b.conv(out_ch, size=1, activation='linear')
    if stride == 1 and in_ch == out_ch:
        out = b.shortcut(block_in)
    return out


def _head_block(b: CfgBuilder, width: int, act: str) -> int:
    """One (1x1 C, dw3x3 C, 1x1 2C) separable bottleneck; returns index of
    the 1x1 C conv (the FPN lateral tap)."""
    tap = b.conv(width, size=1, activation=act)
    b.conv(width, size=3, groups=width, activation=act)
    b.conv(width * 2, size=1, activation=act)
    return tap


def mobilenetv2_fpn(num_classes: int = 20, activation: str = 'relu6',
                    bbox_loss: str = 'giou', gt_per_grid: int = 3,
                    width_mult: float = 1.0) -> str:
    b = CfgBuilder()
    pred_ch = gt_per_grid * (5 + num_classes)

    def scale(c):
        return max(8, int(round(c * width_mult / 8) * 8)) if width_mult != 1.0 else c

    # ---- backbone
    in_ch = scale(32)
    b.conv(in_ch, size=3, stride=2, activation=activation, comment='stem')
    taps = {}  # cumulative stride -> layer index
    cur_stride = 2
    for t, c, n, s in INVERTED_RESIDUAL_SETTINGS:
        c = scale(c)
        for i in range(n):
            stride = s if i == 0 else 1
            if stride == 2:
                # the stride-8/16 taps feed FPN merges
                taps[cur_stride] = b.index
                cur_stride *= 2
            _inverted_residual(b, in_ch, c, t, stride, activation)
            in_ch = c
    b.conv(scale(1280), size=1, activation=activation, comment='tail 1x1')

    # ---- FPN head: large (stride 32) -> middle (16) -> small (8)
    widths = {32: scale(512), 16: scale(256), 8: scale(128)}
    tap16, tap8 = taps[16], taps[8]

    # large
    last_tap = None
    for i in range(3):
        last_tap = _head_block(b, widths[32], activation)
    b.conv(pred_ch, size=1, activation='linear', bn=False)
    b.yolo(num_classes, bbox_loss=bbox_loss)

    # merge to middle
    b.route(last_tap)
    b.conv(widths[16], size=1, activation=activation)
    up = b.upsample()
    b.route([up, tap16])
    for i in range(3):
        last_tap = _head_block(b, widths[16], activation)
    b.conv(pred_ch, size=1, activation='linear', bn=False)
    b.yolo(num_classes, bbox_loss=bbox_loss)

    # merge to small
    b.route(last_tap)
    b.conv(widths[8], size=1, activation=activation)
    up = b.upsample()
    b.route([up, tap8])
    for i in range(3):
        _head_block(b, widths[8], activation)
    b.conv(pred_ch, size=1, activation='linear', bn=False)
    b.yolo(num_classes, bbox_loss=bbox_loss)

    return b.text()
