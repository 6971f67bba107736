"""RegNet design-space math + NAS search-space samplers (the port's copy of
``pqdet_tpu/nas/space.py``, pure numpy).

Width generation follows the published RegNet parameterisation
(Radosavovic et al. 2020): a linear width ramp w_j = w_0 + w_a * j is
quantised to log-space steps of w_m and snapped to multiples of 8, then
grouped into stages. Head sampling mirrors the reference's search space
(nas/detnet.py:33-46): per-branch widths log-uniform, shared depth/group
width, with group-width compatibility adjustment.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

# named design-space instantiations (published RegNetX/Y parameters)
REGNET_CONFIGS = {
    '200M': dict(wa=36.44, w0=24, wm=2.49, depth=13, group_w=8, se_r=None),
    '400M': dict(wa=24.48, w0=24, wm=2.54, depth=22, group_w=16, se_r=None),
    '600M': dict(wa=36.97, w0=48, wm=2.24, depth=16, group_w=24, se_r=None),
    '800M': dict(wa=35.73, w0=56, wm=2.28, depth=16, group_w=16, se_r=None),
    '1600M': dict(wa=34.01, w0=80, wm=2.25, depth=18, group_w=24, se_r=None),
    'Y600M': dict(wa=32.54, w0=48, wm=2.32, depth=15, group_w=16, se_r=0.25),
}


def quantize_float(f, q: int) -> int:
    return int(round(f / q) * q)


def generate_widths(wa: float, w0: int, wm: float, depth: int,
                    q: int = 8) -> List[int]:
    """Per-block widths from the RegNet linear/log parameterisation."""
    assert wa >= 0 and w0 > 0 and wm > 1 and w0 % q == 0
    cont = np.arange(depth) * wa + w0
    ks = np.round(np.log(cont / w0) / np.log(wm))
    ws = w0 * np.power(wm, ks)
    ws = np.round(ws / q) * q
    return ws.astype(int).tolist()


def widths_to_stages(block_ws: Sequence[int]) -> Tuple[List[int], List[int]]:
    """Collapse per-block widths into (stage widths, stage depths)."""
    ws, ds = [], []
    for w in block_ws:
        if not ws or w != ws[-1]:
            ws.append(int(w))
            ds.append(1)
        else:
            ds[-1] += 1
    return ws, ds


def adjust_widths_groups(ws: Sequence[int], gws: Sequence[int],
                         bms: Sequence[float] = None) -> Tuple[List[int], List[int]]:
    """Make widths divisible by their group widths (bottleneck-aware)."""
    bms = bms or [1.0] * len(ws)
    ws_bot = [int(w * b) for w, b in zip(ws, bms)]
    gws = [min(g, wb) for g, wb in zip(gws, ws_bot)]
    ws_bot = [max(quantize_float(wb, g), g) for wb, g in zip(ws_bot, gws)]
    ws = [int(wb / b) for wb, b in zip(ws_bot, bms)]
    return ws, gws


def regnet_stages(config: Dict) -> Dict:
    """Named config -> {'widths', 'depths', 'group_ws', 'se_r'} stage spec."""
    block_ws = generate_widths(config['wa'], config['w0'], config['wm'],
                               config['depth'])
    ws, ds = widths_to_stages(block_ws)
    gws = [config['group_w']] * len(ws)
    ws, gws = adjust_widths_groups(ws, gws)
    return {'widths': ws, 'depths': ds, 'group_ws': gws,
            'se_r': config['se_r']}


def sample_head(rng: np.random.RandomState) -> Dict:
    """Random FPN-head parameters (reference nas/detnet.py:33-46 ranges)."""
    log_ranges = np.log2(np.array([(96, 1024), (120, 1024), (32, 768)]))
    ws = [quantize_float(2 ** rng.uniform(lo, hi), 8) for lo, hi in log_ranges]
    depth = int(round(2 ** rng.uniform(0.0, 2.585)))       # 1..6 blocks
    gw = int(rng.choice([1, 2, 4, 8, 12, 16, 20, 24, 28, 32, 40, 48]))
    ws, gws = adjust_widths_groups(ws, [gw] * 3)
    return {'widths': ws, 'depth': depth, 'group_ws': gws}
