"""Model export: a serialized ``torch.export`` program, darknet
``.weights``, and checkpoint surgery (the port of
``pqdet_tpu/exporters/export.py``).

The JAX package serialises its jitted inference function with
``jax.export`` (StableHLO bytecode). The port's counterpart is a
``torch.export`` program saved to bytes (``torch.export.save``: a ``.pt2``
archive, not StableHLO); the functions keep the JAX names
(``export_stablehlo``, ``export_stablehlo_quant``, ``load_stablehlo``) so
that a reader finds the counterpart. Every artifact has a fixed batch and
input size, takes normalized NHWC f32 images and holds its weights as
buffers; it runs on the device it was exported on.

- fp (``export_stablehlo``): the BN-folded walk and the decode, and with
  ``with_nms`` the fixed-shape NMS, all through the plain versions, as the
  JAX fp export runs ``network.apply`` without the Pallas kernels: the
  program holds no custom operator and any PyTorch runtime loads it;
- int8 (``export_stablehlo_quant``): ``mode='int'`` (the default, as in
  JAX) is ``Int8Inference(mode='int').apply(plain=True)``, plain PyTorch
  ops only; ``mode='kernel'`` (JAX's ``'pallas'``) carries the
  ``qconv1x1_s8``, ``qdwconv3x3_s8`` and ``decode_heads`` operators of
  ``ops/library.py``, so loading it needs ``pqdet_tpu_torch`` importable
  and, to run, the card its kernels build for.
"""

from __future__ import annotations

import io
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from pqdet_tpu_torch import resolve_device
from pqdet_tpu_torch.compress.quantized import Int8Inference
from pqdet_tpu_torch.ops.postprocess import nms_batch


def _buffers(tree: Dict[str, dict]) -> nn.ModuleDict:
    """One module per layer of ``tree`` ({key: {name: tensor}}), each tensor
    a buffer, so the program holds the weights as named state."""
    out = nn.ModuleDict()
    for key, entry in tree.items():
        m = nn.Module()
        for name, t in entry.items():
            m.register_buffer(name, t)
        out[key] = m
    return out


def _tree(layers: nn.ModuleDict) -> Dict[str, dict]:
    return {key: dict(m.named_buffers()) for key, m in layers.items()}


class FpProgram(nn.Module):
    """images -> preds (or the NMS outputs) of the BN-folded fp walk through
    the plain versions."""

    def __init__(self, network, fused_params: Dict, with_nms: bool, nms_args: Tuple):
        super().__init__()
        self.network = network
        self.params = _buffers(fused_params)
        self.with_nms = with_nms
        self.nms_args = nms_args

    def forward(self, images):
        preds = self.network(_tree(self.params), {}, images, plain=True)
        if not self.with_nms:
            return preds
        res = nms_batch(preds, *self.nms_args)
        return res.boxes, res.scores, res.classes, res.valid


class Int8Program(nn.Module):
    """images -> preds of ``Int8Inference`` in ``mode`` over staged int8
    weights held as buffers: ``'int'`` through the plain versions,
    ``'kernel'`` through the registered operators."""

    def __init__(self, network, staged: Dict, mode: str, example: torch.Tensor):
        super().__init__()
        from pqdet_tpu_torch.ops import library
        self.inf = Int8Inference(network, mode=mode)
        self.layers = _buffers(staged['layers'])
        self.act = staged['act']
        self.kernels = library.OPS if mode == 'kernel' else None
        # the kernels' (1, 4) scalar vectors, made once by a plain walk of
        # the example and held as buffers (the JAX package bakes them in as
        # constants); forward hands them to the walk's cache
        if mode == 'kernel':
            with torch.no_grad():
                self.inf.apply(staged, example, plain=True)
        self.scalar_keys = list(self.inf._scalars)
        for j, k in enumerate(self.scalar_keys):
            self.register_buffer(f'scalars{j}', self.inf._scalars[k])

    def forward(self, images):
        self.inf._scalars = {k: getattr(self, f'scalars{j}')
                             for j, k in enumerate(self.scalar_keys)}
        staged = {'layers': _tree(self.layers), 'act': self.act}
        return self.inf.apply(staged, images, plain=self.kernels is None,
                              kernels=self.kernels)


def _on(tree, dev):
    if isinstance(tree, dict):
        return {k: _on(v, dev) for k, v in tree.items()}
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def _serialize(program: nn.Module, example: torch.Tensor) -> bytes:
    with torch.no_grad():
        exported = torch.export.export(program, (example,))
    exported.example_inputs = None      # the zero batch it was traced on: not kept
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    return buf.getvalue()


def _example(batch_size, input_size, dev):
    return torch.zeros((batch_size, *input_size, 3), dtype=torch.float32, device=dev)


def export_stablehlo(network, fused_params: Dict, input_size: Tuple[int, int] = (512, 512),
                     batch_size: int = 1, with_nms: bool = False,
                     score_threshold: float = 0.1, iou_threshold: float = 0.45,
                     max_detections: int = 256, device='cuda') -> bytes:
    """Serialise the fp inference function on ``device`` to ``.pt2`` bytes.

    The program maps images (B, H, W, 3) f32 -> (B, sum HWA, 5+C) decoded
    predictions, or with ``with_nms`` the ``nms_batch`` outputs (boxes,
    scores, classes, valid) of the preds; ``fused_params`` are BN-folded
    (``inference_params``)."""
    dev = resolve_device(device)
    program = FpProgram(network, _on(fused_params, dev), with_nms,
                        (score_threshold, iou_threshold, max_detections))
    return _serialize(program, _example(batch_size, input_size, dev))


def export_stablehlo_quant(network, qparams: Dict, input_size: Tuple[int, int] = (512, 512),
                           batch_size: int = 1, mode: str = 'int', device='cuda') -> bytes:
    """Serialise the int8 executor on ``device`` so a 'quant' checkpoint has
    a deployable artifact: images (B, H, W, 3) f32 -> (B, sum HWA, 5+C)
    preds, the int8 weights as buffers. ``mode``: ``'int'`` (plain PyTorch
    ops, any runtime) or ``'kernel'`` (the registered kernel operators)."""
    if mode not in ('int', 'kernel'):
        raise ValueError(f"mode must be 'int' or 'kernel', got {mode!r}")
    dev = resolve_device(device)
    example = _example(batch_size, input_size, dev)
    staged = Int8Inference.prepare(_on(qparams, dev), mode=mode, network=network)
    return _serialize(Int8Program(network, staged, mode, example), example)


def load_stablehlo(blob: bytes, device='cuda'):
    """Deserialise an exported program; returns its callable module. The
    operators of ``ops/library.py`` are registered first, so a kernel
    artifact loads in a fresh process. Raises when the artifact's tensors
    lie on another device type than ``device``."""
    import pqdet_tpu_torch.ops.library  # noqa: F401  (registers the operators)
    dev = resolve_device(device)
    exported = torch.export.load(io.BytesIO(blob))
    found = {t.device.type for t in [*exported.state_dict.values(),
                                     *exported.constants.values()]
             if isinstance(t, torch.Tensor)}
    if found - {dev.type}:
        raise ValueError(f'the artifact holds tensors on {sorted(found)}; it runs on the '
                         f'device it was exported on, not {dev}')
    return exported.module()


def _host(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), np.float32)


def save_weights_darknet(network, params: Dict, state: Dict, save_path: str, seen: int = 0):
    """Write darknet .weights: int32 header (0, 0, 0, seen) then per conv
    layer [bn beta, gamma, mean, var | bias] + OIHW weights; an fc layer's
    bias then its (out, in) weight. The port's weights are OIHW and (out,
    in) already, so the bytes are the JAX writer's."""
    with open(save_path, 'wb') as fw:
        np.array([0, 0, 0, seen], dtype=np.int32).tofile(fw)
        for node in network.graph.nodes:
            key = str(node.index)
            if node.kind not in ('fc', 'convolutional'):
                continue
            p = params[key]
            if 'bn' in p:
                for t in (p['bn']['beta'], p['bn']['gamma'], state[key]['mean'],
                          state[key]['var']):
                    _host(t).tofile(fw)
            else:
                _host(p['b']).tofile(fw)
            _host(p['w']).tofile(fw)


def load_weights_darknet(network, path: str, params: Dict, state: Dict) -> Tuple[Dict, Dict]:
    """Read darknet .weights into copies of the port's (params, state), each
    tensor on the device and of the dtype of the one it replaces (the
    inverse of ``save_weights_darknet``)."""
    buf = np.fromfile(path, dtype=np.float32)
    pos = 4  # int32 header occupies 4 float32 slots
    new_params = {k: dict(v) for k, v in params.items()}
    new_state = {k: dict(v) for k, v in state.items()}

    def take(like: torch.Tensor) -> torch.Tensor:
        nonlocal pos
        n = like.numel()
        out = buf[pos:pos + n]
        if len(out) != n:
            raise ValueError('darknet weights file truncated')
        pos += n
        return torch.from_numpy(out.reshape(tuple(like.shape)).copy()).to(like.device,
                                                                          like.dtype)

    for node in network.graph.nodes:
        key = str(node.index)
        if node.kind not in ('fc', 'convolutional'):
            continue
        p = params[key]
        if 'bn' in p:
            beta, gamma = take(p['bn']['beta']), take(p['bn']['gamma'])
            mean, var = take(state[key]['mean']), take(state[key]['var'])
            new_params[key]['bn'] = {'gamma': gamma, 'beta': beta}
            new_state[key] = {'mean': mean, 'var': var}
        else:
            new_params[key]['b'] = take(p['b'])
        new_params[key]['w'] = take(p['w'])
    return new_params, new_state


def partial_checkpoint(weight_path: str, save_path: str, layers: int):
    """Keep only graph nodes with index <= layers: a backbone-transfer
    artifact. Works on the checkpoint's numpy pytrees and writes them back
    as they are, so the file is the JAX function's bytes."""
    from pqdet_tpu_torch.utils.codec import load_checkpoint, save_pytrees
    ckpt = load_checkpoint(weight_path)
    keep_p = {k: v for k, v in ckpt['params'].items() if int(k) <= layers}
    keep_s = {k: v for k, v in ckpt['state'].items()
              if k != 'quant' and int(k) <= layers}
    save_pytrees(save_path, keep_p, keep_s, step=0, cfg_text=ckpt.get('cfg', ''))
