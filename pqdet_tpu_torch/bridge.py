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

A QAT state's observers (``state['quant']``: per edge 0-d f32 ``min``
and ``max`` and a 0-d bool ``initialized``) cross with the rest:
``from_jax_quant_state`` and ``to_jax_quant_state`` carry them alone, and
both params functions carry them when the state has them.
``from_jax_qparams`` carries the output of the JAX package's
``convert_to_int8`` (int8 HWIO ``wq``, ``w_scale``, ``b``, and the ``act``
dict of edge (scale, zero point)).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from pqdet_tpu_torch import resolve_device


def _tensor(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(dev)  # a writable copy


def _host(t, dtype=None) -> np.ndarray:
    return np.array(t.detach().to('cpu', dtype).numpy())


def _to_torch_layout(w, kind: str) -> np.ndarray:
    """A JAX weight in the port's layout: conv HWIO -> OIHW, fc (in, out) ->
    (out, in)."""
    w = np.asarray(w)
    return np.ascontiguousarray(w.T if kind == 'fc' else w.transpose(3, 2, 0, 1))


def _to_jax_layout(w: np.ndarray, kind: str) -> np.ndarray:
    """The inverse of ``_to_torch_layout``."""
    return np.ascontiguousarray(w.T if kind == 'fc' else w.transpose(2, 3, 1, 0))


def hwio_to_oihw(w) -> np.ndarray:
    return _to_torch_layout(w, 'convolutional')


def _weighted_nodes(graph, tree: Dict):
    """(key, kind, entry) of each conv and fc node that ``tree`` holds."""
    for node in graph.nodes:
        key = str(node.index)
        if key in tree and node.kind in ('convolutional', 'fc'):
            yield key, node.kind, tree[key]


def from_jax_params(params: Dict, state: Dict, graph,
                    device='cuda') -> Tuple[Dict, Dict]:
    """JAX (params, state) pytrees -> the port's (params, state) on
    ``device``."""
    dev = resolve_device(device)
    out_p: Dict[str, dict] = {}
    out_s: Dict[str, dict] = {}
    for key, kind, p in _weighted_nodes(graph, params):
        q = {'w': _tensor(_to_torch_layout(p['w'], kind), dev)}
        if 'b' in p:
            q['b'] = _tensor(p['b'], dev)
        if 'bn' in p:
            q['bn'] = {'gamma': _tensor(p['bn']['gamma'], dev),
                       'beta': _tensor(p['bn']['beta'], dev)}
            out_s[key] = {'mean': _tensor(state[key]['mean'], dev),
                          'var': _tensor(state[key]['var'], dev)}
        out_p[key] = q
    if 'quant' in state:
        out_s['quant'] = from_jax_quant_state(state, device=dev)
    return out_p, out_s


def to_jax_params(params: Dict, state: Dict, graph) -> Tuple[Dict, Dict]:
    """The port's (params, state) -> JAX's layout as f32 numpy pytrees (conv
    ``w`` HWIO, fc ``w`` (in, out)), keyed as ``from_jax_params`` reads
    them; each array is an exact copy."""
    def host(t):
        return _host(t, torch.float32)

    out_p: Dict[str, dict] = {}
    out_s: Dict[str, dict] = {}
    for key, kind, p in _weighted_nodes(graph, params):
        q = {'w': _to_jax_layout(host(p['w']), kind)}
        if 'b' in p:
            q['b'] = host(p['b'])
        if 'bn' in p:
            q['bn'] = {'gamma': host(p['bn']['gamma']), 'beta': host(p['bn']['beta'])}
            out_s[key] = {'mean': host(state[key]['mean']), 'var': host(state[key]['var'])}
        out_p[key] = q
    if 'quant' in state:
        out_s['quant'] = to_jax_quant_state(state)
    return out_p, out_s


def from_jax_qparams(qparams: Dict, graph, device='cuda') -> Dict:
    """JAX ``convert_to_int8`` output -> the port's int8 qparams on
    ``device``: conv ``wq`` int8 OIHW, ``w_scale`` and ``b`` f32; the edge
    qparams as Python floats."""
    dev = resolve_device(device)
    layers: Dict[str, dict] = {}
    for key, kind, p in _weighted_nodes(graph, qparams['layers']):
        if kind == 'convolutional':
            wq = _to_torch_layout(np.asarray(p['wq'], np.int8), kind)
            layers[key] = {'wq': torch.from_numpy(wq).to(dev),
                           'w_scale': _tensor(p['w_scale'], dev),
                           'b': _tensor(p['b'], dev)}
        else:
            layers[key] = {'w': _tensor(_to_torch_layout(p['w'], kind), dev),
                           'b': _tensor(p['b'], dev)}
    act = {k: (float(v[0]), float(v[1])) for k, v in qparams['act'].items()}
    return {'layers': layers, 'act': act}


def to_jax_qparams(qparams: Dict, graph) -> Dict:
    """The port's int8 qparams -> JAX's ``convert_to_int8`` layout as numpy
    (conv ``wq`` int8 HWIO, ``w_scale`` and ``b`` f32; fc ``w`` (in, out)),
    the inverse of ``from_jax_qparams``."""
    layers: Dict[str, dict] = {}
    for key, kind, p in _weighted_nodes(graph, qparams['layers']):
        if kind == 'convolutional':
            layers[key] = {'wq': _to_jax_layout(_host(p['wq']), kind),
                           'w_scale': _host(p['w_scale'], torch.float32),
                           'b': _host(p['b'], torch.float32)}
        else:
            layers[key] = {'w': _to_jax_layout(_host(p['w']), kind), 'b': _host(p['b'])}
    return {'layers': layers, 'act': dict(qparams['act'])}


def from_jax_quant_state(state: Dict, device='cuda') -> Dict[str, dict]:
    """The observers of a JAX state's ``quant`` entry -> the port's
    ``state['quant']`` dict on ``device`` (0-d f32 ``min``/``max``, 0-d
    bool ``initialized``)."""
    dev = resolve_device(device)
    return {edge: {'min': _tensor(obs['min'], dev), 'max': _tensor(obs['max'], dev),
                   'initialized': torch.tensor(bool(np.asarray(obs['initialized'])),
                                               device=dev)}
            for edge, obs in state['quant'].items()}


def to_jax_quant_state(state: Dict) -> Dict[str, dict]:
    """The port's ``state['quant']`` -> JAX's observers as numpy 0-d arrays
    (f32 ``min``/``max``, bool ``initialized``), the form a qat checkpoint
    holds."""
    return {edge: {'min': _host(obs['min'], torch.float32),
                   'max': _host(obs['max'], torch.float32),
                   'initialized': _host(obs['initialized'], torch.bool)}
            for edge, obs in state['quant'].items()}
