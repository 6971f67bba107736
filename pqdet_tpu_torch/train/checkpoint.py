"""Checkpoints in the JAX package's format (the port of
``pqdet_tpu/train/checkpoint.py``), so a file written by either package
loads in the other.

A checkpoint is one msgpack map, as ``flax.serialization`` writes it:
``step``, ``AP`` (-1.0 for none), ``params`` and ``state`` (the pytrees in
JAX's layout: conv ``w`` HWIO, fc ``w`` (in, out); ``bridge.to_jax_params``
and ``from_jax_params`` convert), ``cfg`` (the architecture's cfg text),
``type`` ('normal' | 'qat' | 'quant') and ``backend``. Every dict is
written with its keys sorted, an ndarray as msgpack ext type 1 holding
``packb((shape, dtype name, C-order bytes))`` and a numpy scalar as ext
type 3 holding the same of its 0-d array: the bytes flax gives for the
same payload. flax splits arrays over 2**30 bytes into chunks; no model
of the port has one, so the codec refuses them.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional, Tuple

import msgpack
import numpy as np
import torch

from pqdet_tpu_torch.bridge import from_jax_params, to_jax_params

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
MAX_ARRAY_BYTES = 2 ** 30


def _array_bytes(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError(f'checkpoint: cannot store dtype {arr.dtype}')
    if arr.nbytes > MAX_ARRAY_BYTES:
        raise ValueError(f'checkpoint: an array of {arr.nbytes} bytes would need '
                         'flax\'s chunked form, which the port does not write')
    return msgpack.packb((arr.shape, arr.dtype.name, arr.tobytes('C')), use_bin_type=True)


def _ext_pack(x):
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(EXT_NDARRAY, _array_bytes(x))
    if isinstance(x, np.generic):
        return msgpack.ExtType(EXT_NPSCALAR, _array_bytes(np.asarray(x)))
    raise TypeError(f'checkpoint: cannot store {type(x).__name__}')


def _array_from(data: bytes) -> np.ndarray:
    shape, dtype, buf = msgpack.unpackb(data, raw=False)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)


def _ext_unpack(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _array_from(data)
    if code == EXT_NPSCALAR:
        return _array_from(data)[()]
    raise ValueError(f'checkpoint: unknown msgpack ext type {code}')


def _sorted_tree(tree):
    if isinstance(tree, dict):
        if '__msgpack_chunked_array__' in tree:
            raise ValueError('checkpoint: flax\'s chunked arrays are not read by the port')
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def dumps(payload: Dict[str, Any]) -> bytes:
    """``payload`` (dicts, str/int/float, numpy arrays and scalars) as the
    bytes of ``flax.serialization.msgpack_serialize``."""
    return msgpack.packb(_sorted_tree(payload), default=_ext_pack, strict_types=True)


def loads(blob: bytes) -> Dict[str, Any]:
    return _sorted_tree(msgpack.unpackb(blob, ext_hook=_ext_unpack, raw=False))


def save_checkpoint(path: str, graph, params: Dict, state: Dict, step: int,
                    cfg_text: str, ap: Optional[float] = None,
                    ckpt_type: str = 'normal', backend: str = 'none'):
    """Write the port's (params, state) of ``graph`` to ``path``, atomically
    (a temporary file of this process and thread, then ``os.replace``)."""
    jp, js = to_jax_params(params, state, graph)
    payload = {
        'step': int(step),
        'AP': -1.0 if ap is None else float(ap),
        'params': jp,
        'state': js,
        'cfg': cfg_text,
        'type': ckpt_type,
        'backend': backend,
    }
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    tmp = f'{path}.{os.getpid()}.{threading.get_ident()}.tmp'
    with open(tmp, 'wb') as fw:
        fw.write(dumps(payload))
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """The payload of a checkpoint, its arrays numpy in JAX's layout."""
    with open(path, 'rb') as fr:
        return loads(fr.read())


def _device_of(params: Dict) -> torch.device:
    for p in params.values():
        return p['w'].device
    return torch.device('cpu')


def load_weights_into(graph, params: Dict, state: Dict,
                      ckpt: Dict[str, Any]) -> Tuple[Dict, Dict]:
    """The checkpoint's weights in place of the port's (params, state) of
    ``graph``, on their device. Strict: the checkpoint's pytrees must have
    the model's keys and shapes, else ``ValueError`` names the first
    mismatch."""
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
