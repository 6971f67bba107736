"""RegNetX/RegNetY backbones + FPN/PAN detection heads (the port's copy of
``pqdet_tpu/zoo/regnet.py``).

Follows the published RegNet design space (Radosavovic et al. 2020, pycls):
X blocks are 1x1 -> 3x3 grouped -> 1x1 residual bottlenecks (bottleneck
ratio 1); Y blocks add squeeze-excite (reduce width = round(w_in/4)) after
the grouped conv. Stage parameters below are the official RegNetX-600MF /
RegNetY-400MF configurations. Head topologies mirror the reference's
generated heads (model/cfg/regnetx-600m-{fpn,pan}.cfg,
regnety-400m-fpn.cfg): three X blocks per scale for FPN with lateral
upsample merges tapping the second block; a PAN adds a bottom-up path with
stride-2 blocks after the top-down pass.
"""

from __future__ import annotations

from typing import Optional

from pqdet_tpu_torch.zoo.builder import CfgBuilder

# official design-space instantiations
REGNETX_600M = dict(widths=(48, 96, 240, 528), depths=(1, 3, 5, 7), group_w=24)
REGNETY_400M = dict(widths=(48, 104, 208, 440), depths=(1, 3, 6, 6), group_w=8)


def _block(b: CfgBuilder, in_ch: int, out_ch: int, group_w: int, stride: int,
           se_ratio: Optional[float] = None) -> int:
    """One RegNet bottleneck block; returns output layer index."""
    groups = out_ch // group_w
    proj = None
    if stride != 1 or in_ch != out_ch:
        proj = b.conv(out_ch, size=1, stride=stride, activation='linear',
                      comment='projection')
        b.route(proj - 1)
    block_in = proj if proj is not None else b.index
    b.conv(out_ch, size=1, activation='relu')
    gconv = b.conv(out_ch, size=3, stride=stride, groups=groups, activation='relu')
    if se_ratio:
        b.avgpool()
        se_w = int(round(in_ch * se_ratio))
        b.conv(se_w, size=1, bn=False, activation='relu')
        b.conv(out_ch, size=1, bn=False, activation='logistic')
        b.scale_channels(gconv)
    b.conv(out_ch, size=1, activation='linear')
    return b.shortcut(block_in, activation='relu')


def _backbone(b: CfgBuilder, spec: dict, se_ratio: Optional[float], act: str = 'relu'):
    """Emit stem + 4 stages; returns taps {8: idx, 16: idx} and out width."""
    b.conv(32, size=3, stride=2, activation=act, comment='simple stem')
    in_ch = 32
    taps = {}
    stride_now = 2
    for stage, (w, d) in enumerate(zip(spec['widths'], spec['depths']), 1):
        for i in range(d):
            stride = 2 if i == 0 else 1
            if stride == 2:
                taps[stride_now] = b.index
                stride_now *= 2
            _block(b, in_ch, w, spec['group_w'], stride, se_ratio)
            in_ch = w
    taps[stride_now] = b.index
    return taps, in_ch


def _fpn_head_scale(b: CfgBuilder, in_ch: int, width: int, group_w: int,
                    num_classes: int, pred_ch: int, bbox_loss: str,
                    l1_loss_gain: float):
    """Three X blocks + pred conv + yolo; returns index of block 2's output
    (the merge tap, matching the reference's `route layers=-7`)."""
    _block(b, in_ch, width, group_w, 1)
    tap = _block(b, width, width, group_w, 1)
    _block(b, width, width, group_w, 1)
    b.conv(pred_ch, size=1, bn=False, activation='linear')
    b.yolo(num_classes, bbox_loss=bbox_loss, l1_loss_gain=l1_loss_gain)
    return tap


def _regnet_fpn(spec: dict, se_ratio: Optional[float], num_classes: int,
                bbox_loss: str, l1_loss_gain: float, gt_per_grid: int = 3) -> str:
    b = CfgBuilder()
    pred_ch = gt_per_grid * (5 + num_classes)
    taps, out_ch = _backbone(b, spec, se_ratio)
    head_widths = {32: 352, 16: 176, 8: 80}
    head_gw = 16

    tap = _fpn_head_scale(b, out_ch, head_widths[32], head_gw, num_classes,
                          pred_ch, bbox_loss, l1_loss_gain)
    for stride in (16, 8):
        b.route(tap)
        b.conv(head_widths[stride], size=1, activation='relu')
        up = b.upsample()
        b.route([up, taps[stride]])
        in_ch = head_widths[stride] + _route_channels(b, taps[stride], spec, stride)
        tap = _fpn_head_scale(b, in_ch, head_widths[stride], head_gw,
                              num_classes, pred_ch, bbox_loss, l1_loss_gain)
    return b.text()


def _route_channels(b: CfgBuilder, tap: int, spec: dict, stride: int) -> int:
    # backbone stage widths at stride 8 / 16 are widths[1] / widths[2]
    return spec['widths'][1] if stride == 8 else spec['widths'][2]


def _pan_block(b: CfgBuilder, width: int, group_w: int, stride: int = 1) -> int:
    """PAN head block: plain 1x1 / grouped 3x3 / 1x1, all relu, no residual."""
    b.conv(width, size=1, activation='relu')
    b.conv(width, size=3, stride=stride, groups=width // group_w, activation='relu')
    return b.conv(width, size=1, activation='relu')


def _regnet_pan(spec: dict, se_ratio: Optional[float], num_classes: int,
                bbox_loss: str, l1_loss_gain: float, gt_per_grid: int = 3) -> str:
    b = CfgBuilder()
    pred_ch = gt_per_grid * (5 + num_classes)
    taps, _ = _backbone(b, spec, se_ratio)
    gw = 16

    def pred_yolo():
        b.conv(pred_ch, size=1, bn=False, activation='linear')
        b.yolo(num_classes, bbox_loss=bbox_loss, l1_loss_gain=l1_loss_gain)

    # top-down pass
    p_large = _pan_block(b, 352, gw)
    b.upsample()
    b.route([b.index, taps[16]])
    p_mid = _pan_block(b, 176, gw)
    b.upsample()
    b.route([b.index, taps[8]])
    p_small = _pan_block(b, 96, gw)
    pred_yolo()

    # bottom-up pass
    b.route(p_small)
    down_mid = _pan_block(b, 176, gw, stride=2)
    b.route([down_mid, p_mid])
    out_mid = _pan_block(b, 176, gw)
    pred_yolo()

    b.route(out_mid)
    down_large = _pan_block(b, 352, gw, stride=2)
    b.route([down_large, p_large])
    _pan_block(b, 352, gw)
    pred_yolo()
    return b.text()


def _rpan_block(b: CfgBuilder, width: int, group_w: int) -> int:
    """Residual PAN block (reference regnetx-600m-rpan.cfg neck blocks,
    e.g. sections 74-79): always-project 1x1 linear + (1x1 relu /
    grouped 3x3 relu / 1x1 linear) body, relu shortcut."""
    proj = b.conv(width, size=1, activation='linear', comment='projection')
    b.route(proj - 1)
    b.conv(width, size=1, activation='relu')
    b.conv(width, size=3, groups=width // group_w, activation='relu')
    b.conv(width, size=1, activation='linear')
    return b.shortcut(proj, activation='relu')


def _regnet_rpan(spec: dict, se_ratio: Optional[float], num_classes: int,
                 bbox_loss: str, l1_loss_gain: float,
                 gt_per_grid: int = 3) -> str:
    """PAN neck with residual blocks (reference model/cfg/
    regnetx-600m-rpan.cfg): top-down and post-concat merge blocks are
    residual (_rpan_block); the stride-2 bottom-up blocks stay plain."""
    b = CfgBuilder()
    pred_ch = gt_per_grid * (5 + num_classes)
    taps, _ = _backbone(b, spec, se_ratio)
    gw = 16

    def pred_yolo():
        b.conv(pred_ch, size=1, bn=False, activation='linear')
        b.yolo(num_classes, bbox_loss=bbox_loss, l1_loss_gain=l1_loss_gain)

    # top-down pass (residual blocks)
    p_large = _rpan_block(b, 352, gw)
    b.upsample()
    b.route([b.index, taps[16]])
    p_mid = _rpan_block(b, 176, gw)
    b.upsample()
    b.route([b.index, taps[8]])
    p_small = _rpan_block(b, 96, gw)
    pred_yolo()

    # bottom-up pass: plain stride-2 down block, concat, residual merge
    b.route(p_small)
    down_mid = _pan_block(b, 176, gw, stride=2)
    b.route([down_mid, p_mid])
    out_mid = _rpan_block(b, 176, gw)
    pred_yolo()

    b.route(out_mid)
    down_large = _pan_block(b, 352, gw, stride=2)
    b.route([down_large, p_large])
    _rpan_block(b, 352, gw)
    pred_yolo()
    return b.text()


def _yolo_scale(b: CfgBuilder, width: int, num_classes: int, pred_ch: int,
                bbox_loss: str, l1_loss_gain: float) -> int:
    """One YOLOv3-style head scale (reference regnetx-600m-yolo.cfg,
    sections 74-84): three depthwise-separable conv pairs
    (1x1 width / dw 3x3 / 1x1 2*width), pred conv + yolo. Returns the
    lateral tap — the THIRD pair's first 1x1 (the cfg's `route -5`)."""
    tap = None
    for i in range(3):
        c1 = b.conv(width, size=1, activation='relu')
        if i == 2:
            tap = c1
        b.conv(width, size=3, groups=width, activation='relu')
        b.conv(width * 2, size=1, activation='relu')
    b.conv(pred_ch, size=1, bn=False, activation='linear')
    b.yolo(num_classes, bbox_loss=bbox_loss, l1_loss_gain=l1_loss_gain)
    return tap


def _regnet_yolo(spec: dict, se_ratio: Optional[float], num_classes: int,
                 bbox_loss: str, l1_loss_gain: float,
                 gt_per_grid: int = 3) -> str:
    """Plain YOLOv3 top-down neck over the RegNet backbone (reference
    model/cfg/regnetx-600m-yolo.cfg): depthwise-separable conv5 heads at
    512/256/128 width, laterals tapped inside the third pair."""
    b = CfgBuilder()
    pred_ch = gt_per_grid * (5 + num_classes)
    taps, _ = _backbone(b, spec, se_ratio)
    widths = {32: 512, 16: 256, 8: 128}

    tap = _yolo_scale(b, widths[32], num_classes, pred_ch, bbox_loss,
                      l1_loss_gain)
    for stride in (16, 8):
        b.route(tap)
        b.conv(widths[stride], size=1, activation='relu')
        up = b.upsample()
        b.route([up, taps[stride]])
        tap = _yolo_scale(b, widths[stride], num_classes, pred_ch, bbox_loss,
                          l1_loss_gain)
    return b.text()


def regnetx_600m_fpn(num_classes: int = 20, bbox_loss: str = 'giou',
                     l1_loss_gain: float = 0.05) -> str:
    return _regnet_fpn(REGNETX_600M, None, num_classes, bbox_loss, l1_loss_gain)


def regnetx_600m_pan(num_classes: int = 20, bbox_loss: str = 'giou',
                     l1_loss_gain: float = 0.05) -> str:
    return _regnet_pan(REGNETX_600M, None, num_classes, bbox_loss, l1_loss_gain)


def regnety_400m_fpn(num_classes: int = 20, bbox_loss: str = 'giou',
                     l1_loss_gain: float = 0.05) -> str:
    return _regnet_fpn(REGNETY_400M, 0.25, num_classes, bbox_loss, l1_loss_gain)


def regnetx_600m_rpan(num_classes: int = 20, bbox_loss: str = 'ciou',
                      l1_loss_gain: float = 0.05) -> str:
    """Residual-PAN variant (reference ships it with bbox_loss=ciou)."""
    return _regnet_rpan(REGNETX_600M, None, num_classes, bbox_loss,
                        l1_loss_gain)


def regnetx_600m_yolo(num_classes: int = 20, bbox_loss: str = 'l1',
                      l1_loss_gain: float = 0.05) -> str:
    """Plain-YOLOv3-neck variant (reference ships it with bbox_loss=l1)."""
    return _regnet_yolo(REGNETX_600M, None, num_classes, bbox_loss,
                        l1_loss_gain)
