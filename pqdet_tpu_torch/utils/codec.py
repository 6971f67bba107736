"""The checkpoint file format shared by both packages: one msgpack map, as
``flax.serialization`` writes it: ``step``, ``AP`` (-1.0 for none),
``params`` and ``state`` (numpy pytrees in JAX's layout), ``cfg`` (the
architecture's cfg text), ``type`` ('normal' | 'qat' | 'quant') and
``backend``. Every dict is written with its keys sorted, an ndarray as
msgpack ext type 1 holding ``packb((shape, dtype name, C-order bytes))``
and a numpy scalar as ext type 3 holding the same of its 0-d array: the
bytes flax gives for the same payload. flax splits arrays over 2**30 bytes
into chunks; no model of the port has one, so the codec refuses them.

``train/checkpoint.py`` writes and loads the port's fp and qat
checkpoints through it, ``compress/quantized.py`` the int8 ones.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

import msgpack
import numpy as np

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


def save_pytrees(path: str, params: Dict, state: Dict, step: int, cfg_text: str,
                 ap: Optional[float] = None, ckpt_type: str = 'normal', backend: str = 'none'):
    """Write numpy pytrees that are already in JAX's layout (what
    ``save_checkpoint`` and ``compress.quantized.save_quantized`` store) to
    ``path``, atomically."""
    payload = {
        'step': int(step),
        'AP': -1.0 if ap is None else float(ap),
        'params': params,
        'state': state,
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
