"""The plain reference of int8 serving: calibration, conversion and the
integer forward, written from the quantisation scheme.

The scheme (the configuration's ``precision: int8``):

- the quant graph runs plain relu wherever the float graph has a
  non-linear activation (relu6, leaky, logistic, tanh or mish, a
  squeeze-excite's sigmoid too); linear stays linear;
- weights: per-output-channel symmetric, scale absmax / 127, codes in
  [-127, 127], of the BN-folded weights;
- activations: per-tensor affine uint8 on every edge but the convs that
  feed a yolo head, whose output stays float. An edge's range comes from a
  moving-average min/max observer (momentum 0.01, the first pass sets it);
  scale = (max(mx, 0) - min(mn, 0)) / 255, zero point round(-min / scale)
  in [0, 255];
- calibration: ``passes`` forward passes of the fake-quantised walk, BN on
  its running statistics and unfolded: the input and each observed edge
  quantised and dequantised with the observer as updated by that pass, each
  conv's weights per output channel;
- the int8 forward: a conv sums codes minus the zero point times weight
  codes exactly (float64), scales the sum by s_x * s_w, adds the folded
  bias, applies the activation and requantises to its edge. A shortcut, a
  route, a maxpool, the global avgpool or a scale_channels dequantises its
  inputs, adds, concatenates, pools or multiplies in float (``net.py``'s
  definitions), and requantises to its own edge; upsampling repeats codes.
  Calibration observes the outputs of all of them.

``levels`` (255, the default) and ``wmax`` (127) set the widths; the
control of ``benchmark/control.py`` runs the same scheme at int4 (15, 7).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from . import net as N

MOMENTUM = 0.01


def quant_act(lay: Dict) -> str:
    a = lay.get('act', 'linear')
    return 'linear' if a == 'linear' else 'relu'


def observed_edges(lays: List[Dict]) -> List[str]:
    feeders = {l['index'] - 1 for l in lays if l['kind'] == 'yolo'}
    return ['input'] + [str(l['index']) for l in lays
                        if l['kind'] != 'yolo' and l['index'] not in feeders]


def qparams(obs, levels: int):
    mn, mx = min(obs[0], 0.0), max(obs[1], 0.0)
    scale = max((mx - mn) / levels, 1e-8)
    zp = min(max(round(-mn / scale), 0), levels)
    return scale, float(zp)


def fake_act(x, sz, levels):
    s, zp = sz
    return (torch.clamp(torch.round(x / s + zp), 0, levels) - zp) * s


def quant_w(w, wmax):
    """(codes, per-channel scale) of OIHW ``w``."""
    scale = (w.abs().amax(dim=(1, 2, 3)) / wmax).clamp_min(1e-8)
    return torch.clamp(torch.round(w / scale[:, None, None, None]), -wmax, wmax), scale


def calibrate(lays, params, state, batches, levels=255, wmax=127) -> Dict[str, tuple]:
    """{edge: (min, max)} after one observer pass over each of ``batches``
    (normalized NHWC f32)."""
    edges = set(observed_edges(lays))
    obs: Dict[str, tuple] = {}

    def seen(key, x):
        if key not in edges:
            return x
        mn, mx = float(x.min()), float(x.max())
        if key in obs:
            mn = (1 - MOMENTUM) * obs[key][0] + MOMENTUM * mn
            mx = (1 - MOMENTUM) * obs[key][1] + MOMENTUM * mx
        obs[key] = (mn, mx)
        return fake_act(x, qparams(obs[key], levels), levels)

    def conv(l, x):
        key = str(l['index'])
        p = params[key]
        codes, scale = quant_w(p['w'].float(), wmax)
        y = F.conv2d(x, codes * scale[:, None, None, None], p.get('b'), l['stride'],
                     l['pad'], 1, l['groups'])
        if 'bn' in p:
            s = state[key]
            y = F.batch_norm(y, s['mean'], s['var'], p['bn']['gamma'], p['bn']['beta'],
                             False, 0.0, N.BN_EPS)
        return seen(key, N.ACTS[quant_act(l)](y))

    with torch.no_grad():
        for x in batches:
            walk(lays, seen('input', x.permute(0, 3, 1, 2).float()), conv, seen)
    return obs


FLOAT_NODES = ('shortcut', 'route') + N.POOL_OR_SCALE


def float_node(l, x, outs):
    """The float output of a shortcut, route, pool or scale_channels ``l``
    on the map before it, ``x``, and the kept outputs ``outs``."""
    if l['kind'] == 'shortcut':
        return N.ACTS[quant_act(l)](x + outs[l['refs'][0]])
    if l['kind'] == 'route':
        return torch.cat([outs[r] for r in l['refs']], 1)
    return N.pool_or_scale(l, x, outs)


def walk(lays, x, conv, seen):
    """``net.walk`` with every non-conv output handed to ``seen``."""
    keep = {r for l in lays for r in l.get('refs', ())}
    outs = {}
    for l in lays:
        k, key = l['kind'], str(l['index'])
        if k == 'convolutional':
            x = conv(l, x)
        elif k in FLOAT_NODES:
            x = seen(key, float_node(l, x, outs))
        elif k == 'upsample':
            x = seen(key, F.interpolate(x, scale_factor=l['stride'], mode='nearest'))
        if l['index'] in keep:
            outs[l['index']] = x
    return x


def convert(lays, params, state, obs, levels=255, wmax=127):
    """Int8 model: ({layer: (weight codes, weight scale, bias)}, {edge:
    (scale, zero point)})."""
    layers = {}
    for l in lays:
        if l['kind'] != 'convolutional':
            continue
        key = str(l['index'])
        w, b = N.fold(params[key], state.get(key))
        codes, scale = quant_w(w, wmax)
        layers[key] = (codes.double(), scale.double(), b.double())
    return layers, {k: qparams(v, levels) for k, v in obs.items()}


def infer(lays, model, x_nhwc, levels=255) -> torch.Tensor:
    """The integer forward of normalized NHWC ``x_nhwc``: (B, sum HWA, 5 + C)."""
    layers, act = model

    def q(y, sz):
        s, zp = sz
        return torch.clamp(torch.round(y / s + zp), 0, levels)

    def dq(v):
        t, sz = v
        return t if sz is None else (t - sz[1]) * sz[0]

    keep = {r for l in lays for r in l.get('refs', ())}
    outs = {}
    raws = []
    with torch.no_grad():
        cur = (q(x_nhwc.permute(0, 3, 1, 2).double(), act['input']), act['input'])
        for l in lays:
            k, key = l['kind'], str(l['index'])
            if k == 'convolutional':
                codes, wscale, b = layers[key]
                t, sz = cur
                xs = t - sz[1]
                acc = F.conv2d(xs, codes, None, l['stride'], l['pad'], 1, l['groups'])
                y = acc * (sz[0] * wscale)[None, :, None, None] + b[None, :, None, None]
                y = N.ACTS[quant_act(l)](y)
            elif k in FLOAT_NODES:
                y = float_node(l, dq(cur), {r: dq(outs[r]) for r in l.get('refs', ())})
            elif k == 'upsample':
                t, sz = cur
                y = F.interpolate(t, scale_factor=l['stride'], mode='nearest')
                cur = (y, sz)
            elif k == 'yolo':
                raws.append((dq(cur).float(), l))
            if k == 'convolutional' or k in FLOAT_NODES:
                cur = (q(y, act[key]), act[key]) if key in act else (y, None)
            if l['index'] in keep:
                outs[l['index']] = cur
        return torch.cat([N.decode(r, l['classes'], l['stride_total']) for r, l in raws], 1)
