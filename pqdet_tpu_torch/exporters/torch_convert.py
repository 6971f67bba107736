"""Convert reference (PyTorch PQDet) checkpoints to and from the port's
trees (the port of ``pqdet_tpu/exporters/torch_convert.py``).

The reference's checkpoints are ``{step, AP, model: state_dict, cfg, type,
backend}`` with module-list-indexed keys like ``module_list.12.conv.weight``
(and an optional DataParallel ``module.`` prefix). Its conv weights are
OIHW and its fc weights (out, in), as the port's are, so nothing is
transposed here; BN splits into params (gamma/beta) and state (mean/var).
The conversions work on the host: they return CPU tensors (or numpy
arrays), and ``convert_torch_checkpoint`` writes a checkpoint in the JAX
package's layout, as every port checkpoint is.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch


def _cpu_f32(v) -> torch.Tensor:
    arr = v.detach().cpu().numpy() if hasattr(v, 'detach') else np.asarray(v)
    return torch.from_numpy(np.array(arr, np.float32))


def convert_torch_state_dict(state_dict: Dict, network) -> Tuple[Dict, Dict]:
    """Reference state_dict (tensor or ndarray values) -> the port's
    (params, state), f32 CPU tensors."""
    flat = {}
    for key, val in state_dict.items():
        if key.startswith('module.'):
            key = key[len('module.'):]
        flat[key] = val

    params: Dict[str, dict] = {}
    state: Dict[str, dict] = {}
    for node in network.graph.nodes:
        i = str(node.index)
        base = f'module_list.{node.index}'
        if node.kind == 'convolutional':
            p = {'w': _cpu_f32(flat[f'{base}.conv.weight'])}          # OIHW
            if node.has_bn:
                p['bn'] = {'gamma': _cpu_f32(flat[f'{base}.bn.weight']),
                           'beta': _cpu_f32(flat[f'{base}.bn.bias'])}
                state[i] = {'mean': _cpu_f32(flat[f'{base}.bn.running_mean']),
                            'var': _cpu_f32(flat[f'{base}.bn.running_var'])}
            else:
                p['b'] = _cpu_f32(flat[f'{base}.conv.bias'])
            params[i] = p
        elif node.kind == 'fc':
            params[i] = {'w': _cpu_f32(flat[f'{base}.fc.weight']),
                         'b': _cpu_f32(flat[f'{base}.fc.bias'])}
    return params, state


def convert_to_torch_state_dict(params: Dict, state: Dict, network) -> Dict:
    """The port's (params, state) -> reference state_dict (numpy values):
    the inverse of ``convert_torch_state_dict``, used by the differential
    evaluation (``cli/diffeval.py``) to run the port's weights through the
    reference's own eval pipeline. Wrap the values with
    ``torch.from_numpy`` for ``load_state_dict``."""
    def host(t):
        return np.ascontiguousarray(t.detach().cpu().numpy())

    flat: Dict[str, np.ndarray] = {}
    for node in network.graph.nodes:
        i = str(node.index)
        base = f'module_list.{node.index}'
        p = params.get(i)
        if p is None:
            continue
        if node.kind == 'convolutional':
            flat[f'{base}.conv.weight'] = host(p['w'])
            if node.has_bn:
                flat[f'{base}.bn.weight'] = host(p['bn']['gamma'])
                flat[f'{base}.bn.bias'] = host(p['bn']['beta'])
                flat[f'{base}.bn.running_mean'] = host(state[i]['mean'])
                flat[f'{base}.bn.running_var'] = host(state[i]['var'])
                flat[f'{base}.bn.num_batches_tracked'] = np.asarray(0)
            else:
                flat[f'{base}.conv.bias'] = host(p['b'])
        elif node.kind == 'fc':
            flat[f'{base}.fc.weight'] = host(p['w'])
            flat[f'{base}.fc.bias'] = host(p['b'])
    return flat


def convert_torch_checkpoint(torch_path: str, save_path: str):
    """Load a reference .pt checkpoint and save a port checkpoint (the JAX
    package's layout) keeping its step, AP, type and cfg text."""
    from pqdet_tpu_torch.model.network import DetectionNetwork
    from pqdet_tpu_torch.train.checkpoint import save_checkpoint

    blob = torch.load(torch_path, map_location='cpu', weights_only=False)
    cfg_text = blob['cfg']
    network = DetectionNetwork.from_cfg(cfg_text)
    params, state = convert_torch_state_dict(blob['model'], network)
    ap = blob.get('AP')
    ap_val = float(ap.AP) if hasattr(ap, 'AP') else None
    save_checkpoint(save_path, network.graph, params, state, step=int(blob.get('step', 0)),
                    cfg_text=cfg_text, ap=ap_val, ckpt_type=blob.get('type', 'normal'))
    return save_path
