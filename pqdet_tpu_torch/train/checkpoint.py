"""Checkpoints in the JAX package's format (the port of
``pqdet_tpu/train/checkpoint.py``), so a file written by either package
loads in the other.

The file is the msgpack map of ``utils/codec.py`` (flax's bytes). Its
``params`` and ``state`` are the pytrees in JAX's layout: conv ``w`` HWIO,
fc ``w`` (in, out); a qat checkpoint's state also holds the observers under
``quant``, 0-d arrays. ``bridge.to_jax_params`` and ``from_jax_params``
convert.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from pqdet_tpu_torch.bridge import from_jax_params, to_jax_params
# load_checkpoint is part of this module's API, as in the JAX package
from pqdet_tpu_torch.utils.codec import load_checkpoint, save_pytrees  # noqa: F401


def save_checkpoint(path: str, graph, params: Dict, state: Dict, step: int,
                    cfg_text: str, ap: Optional[float] = None,
                    ckpt_type: str = 'normal', backend: str = 'none'):
    """Write the port's (params, state) of ``graph`` to ``path``, atomically
    (a temporary file of this process and thread, then ``os.replace``)."""
    jp, js = to_jax_params(params, state, graph)
    save_pytrees(path, jp, js, step, cfg_text, ap=ap, ckpt_type=ckpt_type, backend=backend)


def _device_of(params: Dict) -> torch.device:
    for p in params.values():
        return p['w'].device
    return torch.device('cpu')


def load_weights_into(graph, params: Dict, state: Dict,
                      ckpt: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """The checkpoint's weights in place of the port's (params, state) of
    ``graph``, on their device, the observers with them when ``state`` has
    ``quant``. Strict: the checkpoint's pytrees must have the model's keys
    and shapes, else ``ValueError`` names the first mismatch."""
    tp, ts = to_jax_params(params, state, graph)

    def merge(template, loaded, path=''):
        if isinstance(template, dict):
            if not isinstance(loaded, dict):
                raise ValueError(f'checkpoint mismatch at {path or "/"}: not a mapping')
            missing = set(template) - set(loaded)
            extra = set(loaded) - set(template)
            if missing or extra:
                raise ValueError(
                    f'checkpoint mismatch at {path or "/"}: missing {sorted(missing)},'
                    f' unexpected {sorted(extra)}')
            return {k: merge(template[k], loaded[k], f'{path}/{k}') for k in template}
        arr = np.asarray(loaded)
        if arr.shape != template.shape:
            raise ValueError(f'shape mismatch at {path}: {arr.shape} vs {template.shape}')
        return arr.astype(template.dtype)

    return from_jax_params(merge(tp, ckpt['params']), merge(ts, ckpt['state']), graph,
                           device=_device_of(params))


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return np.shape(tree)


def load_backbone_into(graph, params: Dict, state: Dict,
                       ckpt: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """Layer-subset load for backbone transfer: every layer of the
    checkpoint whose key, structure and shapes match the model's
    overwrites it (its BN state with it); the other layers keep theirs."""
    tp, ts = to_jax_params(params, state, graph)
    for key, val in ckpt['params'].items():
        if key in tp and _shapes(tp[key]) == _shapes(val):
            tp[key] = val
    for key, val in ckpt.get('state', {}).items():
        if key in ts:
            ts[key] = val
    return from_jax_params(tp, ts, graph, device=_device_of(params))
