"""DetNet candidate generator (the port of ``pqdet_tpu/nas/detnet.py``): a
RegNet backbone and a sampled 3-branch FPN head, emitted as cfg text so every
candidate flows through the same graph, trainer and exporters as a zoo
model. For the same ``RandomState`` a candidate's cfg text is the JAX
package's letter for letter.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from pqdet_tpu_torch.nas.space import REGNET_CONFIGS, regnet_stages, sample_head
from pqdet_tpu_torch.zoo.builder import CfgBuilder
from pqdet_tpu_torch.zoo.regnet import _backbone, _block


def build_detnet_cfg(backbone: Dict, head: Dict, num_classes: int = 20,
                     gt_per_grid: int = 3, bbox_loss: str = 'giou',
                     exp_cap: float = 40.0) -> str:
    """backbone: ``regnet_stages()`` output; head: ``sample_head()`` output.

    ``exp_cap`` (40 for NAS candidates, 0 disables) clamps the decode's exp
    argument so a deep sampled head cannot push the forward to inf at the
    short warm-up's learning rate (``model/decode.py``)."""
    b = CfgBuilder()
    pred_ch = gt_per_grid * (5 + num_classes)
    spec = {'widths': tuple(backbone['widths']),
            'depths': tuple(backbone['depths']),
            'group_w': backbone['group_ws'][0]}
    taps, out_ch = _backbone(b, spec, backbone['se_r'])

    in_ch = out_ch
    tap = None
    for i, stride in enumerate((32, 16, 8)):
        w, gw = head['widths'][i], head['group_ws'][i]
        if stride != 32:
            b.route(tap)
            b.conv(w, size=1, activation='relu')
            up = b.upsample()
            b.route([up, taps[stride]])
            in_ch = w + _stage_width_at(backbone, stride)
        for j in range(head['depth']):
            tap_j = _block(b, in_ch if j == 0 else w, w, gw, 1)
            if j == max(head['depth'] - 2, 0):
                tap = tap_j
        b.conv(pred_ch, size=1, bn=False, activation='linear')
        b.yolo(num_classes, bbox_loss=bbox_loss, l1_loss_gain=0.05,
               exp_cap=exp_cap)
    return b.text()


def _stage_width_at(backbone: Dict, stride: int) -> int:
    # backbone stages sit at strides 4/8/16/32; taps feed strides 8 and 16
    idx = {8: 1, 16: 2}[stride]
    return backbone['widths'][idx]


def detnet_600m(num_classes: int = 20,
                rng: Optional[np.random.RandomState] = None,
                return_head: bool = False, exp_cap: float = 40.0):
    """A random candidate around the RegNetX-600MF backbone. With
    ``return_head`` also returns the sampled head dict, which the search
    logs for the EDF analysis (``nas/analysis.py``)."""
    rng = rng or np.random.RandomState()
    backbone = regnet_stages(REGNET_CONFIGS['600M'])
    head = sample_head(rng)
    cfg = build_detnet_cfg(backbone, head, num_classes=num_classes,
                           exp_cap=exp_cap)
    return (cfg, head) if return_head else cfg
