"""Carry the JAX package's parameters into the port.

``from_jax_params`` takes the pytrees of ``pqdet_tpu``'s ``Network.init``
(or its BN-folded ``fuse_params`` form) as numpy-convertible arrays keyed
by ``str(node_index)``: a conv holds ``w`` in HWIO, an optional ``b`` and
an optional ``bn`` with ``gamma`` and ``beta``, whose ``mean`` and ``var``
are in ``state``; an fc holds ``w`` (in, out) and ``b``. It returns the
port's dicts, conv weights in OIHW and fc weights in torch's (out, in),
keeping its own copy of the HWIO -> OIHW rule of
``pqdet_tpu/exporters/torch_convert.py``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from pqdet_tpu_torch import resolve_device


def _tensor(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(dev)  # a writable copy


def hwio_to_oihw(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))


def from_jax_params(params: Dict, state: Dict, graph,
                    device='cuda') -> Tuple[Dict, Dict]:
    """JAX (params, state) pytrees -> the port's (params, state) on
    ``device``."""
    dev = resolve_device(device)
    out_p: Dict[str, dict] = {}
    out_s: Dict[str, dict] = {}
    for node in graph.nodes:
        key = str(node.index)
        p = params.get(key)
        if p is None:
            continue
        if node.kind == 'convolutional':
            q = {'w': _tensor(hwio_to_oihw(p['w']), dev)}
            if 'b' in p:
                q['b'] = _tensor(p['b'], dev)
            if 'bn' in p:
                q['bn'] = {'gamma': _tensor(p['bn']['gamma'], dev),
                           'beta': _tensor(p['bn']['beta'], dev)}
                out_s[key] = {'mean': _tensor(state[key]['mean'], dev),
                              'var': _tensor(state[key]['var'], dev)}
            out_p[key] = q
        elif node.kind == 'fc':
            out_p[key] = {'w': _tensor(np.asarray(p['w']).T, dev),
                          'b': _tensor(p['b'], dev)}
    return out_p, out_s
