"""Carry the JAX package's parameters into the port.

``from_jax_params`` takes the pytrees of ``pqdet_tpu``'s ``Network.init``
(or its BN-folded ``fuse_params`` form) as numpy-convertible arrays keyed
by ``str(node_index)``: a conv holds ``w`` in HWIO, an optional ``b`` and
an optional ``bn`` with ``gamma`` and ``beta``, whose ``mean`` and ``var``
are in ``state``; an fc holds ``w`` (in, out) and ``b``. It returns the
port's dicts, conv weights in OIHW and fc weights in torch's (out, in),
keeping its own copy of the HWIO -> OIHW rule of
``pqdet_tpu/exporters/torch_convert.py``. ``to_jax_params`` is its
inverse: the port's (params, state) as numpy pytrees in JAX's layout, the
form a checkpoint holds (``train/checkpoint.py``).

``from_jax_qparams`` carries the output of the JAX package's
``convert_to_int8`` (int8 HWIO ``wq``, ``w_scale``, ``b``, and the ``act``
dict of edge (scale, zero point)) and ``from_jax_quant_state`` its QAT
observers (``state['quant']``: ``min``, ``max``, ``initialized``).
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


def to_jax_params(params: Dict, state: Dict, graph) -> Tuple[Dict, Dict]:
    """The port's (params, state) -> JAX's layout as f32 numpy pytrees (conv
    ``w`` HWIO, fc ``w`` (in, out)), keyed as ``from_jax_params`` reads
    them; each array is an exact copy."""
    def host(t):
        return np.array(t.detach().to('cpu', torch.float32).numpy())

    out_p: Dict[str, dict] = {}
    out_s: Dict[str, dict] = {}
    for node in graph.nodes:
        key = str(node.index)
        p = params.get(key)
        if p is None:
            continue
        if node.kind == 'convolutional':
            q = {'w': np.ascontiguousarray(host(p['w']).transpose(2, 3, 1, 0))}
            if 'b' in p:
                q['b'] = host(p['b'])
            if 'bn' in p:
                q['bn'] = {'gamma': host(p['bn']['gamma']), 'beta': host(p['bn']['beta'])}
                out_s[key] = {'mean': host(state[key]['mean']), 'var': host(state[key]['var'])}
            out_p[key] = q
        elif node.kind == 'fc':
            out_p[key] = {'w': np.ascontiguousarray(host(p['w']).T), 'b': host(p['b'])}
    return out_p, out_s


def from_jax_qparams(qparams: Dict, graph, device='cuda') -> Dict:
    """JAX ``convert_to_int8`` output -> the port's int8 qparams on
    ``device``: conv ``wq`` int8 OIHW, ``w_scale`` and ``b`` f32; the edge
    qparams as Python floats."""
    dev = resolve_device(device)
    layers: Dict[str, dict] = {}
    for node in graph.nodes:
        key = str(node.index)
        p = qparams['layers'].get(key)
        if p is None:
            continue
        if node.kind == 'convolutional':
            wq = hwio_to_oihw(np.asarray(p['wq'], np.int8))
            layers[key] = {'wq': torch.from_numpy(wq).to(dev),
                           'w_scale': _tensor(p['w_scale'], dev),
                           'b': _tensor(p['b'], dev)}
        elif node.kind == 'fc':
            layers[key] = {'w': _tensor(np.asarray(p['w']).T, dev),
                           'b': _tensor(p['b'], dev)}
    act = {k: (float(v[0]), float(v[1])) for k, v in qparams['act'].items()}
    return {'layers': layers, 'act': act}


def from_jax_quant_state(state: Dict, device='cuda') -> Dict[str, dict]:
    """The observers of a JAX state's ``quant`` entry -> the port's
    ``state['quant']`` dict on ``device`` (0-d f32 ``min``/``max``, 0-d
    bool ``initialized``)."""
    dev = resolve_device(device)
    return {edge: {'min': _tensor(obs['min'], dev), 'max': _tensor(obs['max'], dev),
                   'initialized': torch.tensor(bool(np.asarray(obs['initialized'])),
                                               device=dev)}
            for edge, obs in state['quant'].items()}
