"""Seeded weights, made on the device in two large draws.

Only convs have weights: a pool, a scale_channels, a shortcut, a route or
an upsample draws nothing, so a cfg draws the same numbers in the same
order whatever other layers it holds.

Both the program and the reference take these same tensors; each derives
from them what it needs (BN folds, casts, quantised codes) on its own.

A conv weight is uniform in +-gain / sqrt(fan_in) (PyTorch's default
kaiming-uniform bound, 1 / sqrt(fan_in), times the configuration's
``gain``); a conv without BN has a bias uniform in +-1 / sqrt(fan_in). A BN
has gamma and the running var uniform in [0.8, 1.2], beta and the running
mean 0.1 x a standard normal, as a trained model holds them. With gain 1
and identity BN the activations fade over the depth and every score sits
near 0.25; the gain and the statistics keep them at scale, so scores spread
and NMS has work.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def make(lays: List[Dict], gen: torch.Generator, gain: float, device) -> Tuple[Dict, Dict]:
    """(params, state) keyed ``str(layer index)`` (see ``reference/net.py``)."""
    convs = [l for l in lays if l['kind'] == 'convolutional']
    n_uniform = n_normal = 0
    for l in convs:
        n_uniform += l['cout'] * (l['cin'] // l['groups']) * l['size'] ** 2
        n_uniform += 2 * l['cout'] if l['bn'] else l['cout']
        n_normal += 2 * l['cout'] if l['bn'] else 0
    uni = torch.rand(n_uniform, generator=gen, device=device)
    nor = torch.randn(n_normal, generator=gen, device=device)
    params, state = {}, {}
    u = v = 0

    def take_u(n):
        nonlocal u
        u += n
        return uni[u - n:u]

    def take_n(n):
        nonlocal v
        v += n
        return nor[v - n:v]
    for l in convs:
        cout, cin_g, k = l['cout'], l['cin'] // l['groups'], l['size']
        bound = 1.0 / math.sqrt(cin_g * k * k)
        w = (take_u(cout * cin_g * k * k).view(cout, cin_g, k, k) * 2 - 1) * (bound * gain)
        key = str(l['index'])
        if l['bn']:
            gamma = 0.8 + 0.4 * take_u(cout)
            var = 0.8 + 0.4 * take_u(cout)
            beta = 0.1 * take_n(cout)
            mean = 0.1 * take_n(cout)
            params[key] = {'w': w, 'bn': {'gamma': gamma, 'beta': beta}}
            state[key] = {'mean': mean, 'var': var}
        else:
            params[key] = {'w': w, 'b': (take_u(cout) * 2 - 1) * bound}
    return params, state

