"""Evaluator for the ONNX op subset the exporters emit, in torch ops on a
device (the port of ``pqdet_tpu/exporters/onnx_runtime.py``).

It plays the role onnxruntime plays for the reference: the round-trip
checks run a serialized graph here and compare it with the port's walk or
int8 executor, on the CPU or on the card, with no onnx install. It is a
checker, not a serving path, and runs no hand-written kernel.

Each op follows the JAX package's numpy evaluator step by step: Conv and
QLinearConv sum in float64 (exact for the integer sums of QLinearConv),
the QLinearConv sum is rounded to f32 before its bias and scales, as the
numpy evaluator's is, and scalars divide as 0-d tensors (CUDA turns a
division by a Python number into a multiplication by its reciprocal).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from pqdet_tpu_torch import resolve_device
from pqdet_tpu_torch.exporters import onnx_proto as P


def _conv(x, w, b, a):
    """Conv of NCHW ``x`` with OIHW ``w`` in float64; symmetric pads as the
    exporters write them."""
    pads = a.get('pads', [0] * 4)
    return F.conv2d(x.double(), w.double(), None if b is None else b.double(),
                    stride=tuple(a.get('strides', [1, 1])), padding=(pads[0], pads[1]),
                    groups=a.get('group', 1))


def _scalar(t) -> float:
    return float(t.reshape(()).item())


def run_model(model_bytes: bytes, feeds: Dict[str, np.ndarray], device='cuda'):
    """Execute a serialized model on ``device``; returns the list of graph
    output tensors there. ``feeds`` are numpy arrays or tensors."""
    dev = resolve_device(device)
    m = P.decode_model(model_bytes)
    P.check_model(m)
    g = m['graph']
    env: Dict[str, torch.Tensor] = {
        k: (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))).to(dev)
        for k, v in feeds.items()}
    for t in g['initializer']:
        env[t['name']] = torch.from_numpy(np.array(P.tensor_to_numpy(t))).to(dev)

    def tensor_scalar(t, dtype):
        return torch.tensor(_scalar(t), dtype=dtype, device=dev)

    for n in g['node']:
        op = n['op_type']
        a = P.node_attrs(n)
        x = [env[i] if i else None for i in n['input']]
        if op == 'Conv':
            y = _conv(x[0], x[1], x[2] if len(x) > 2 else None, a).float()
        elif op == 'QLinearConv':
            xq, xs, xzp, wq, ws, wzp, ys, yzp = x[:8]
            bias = x[8] if len(x) > 8 else None
            xf = xq.to(torch.int32) - int(_scalar(xzp))
            wf = wq.to(torch.int32) - wzp.to(torch.int32).reshape(-1, 1, 1, 1)
            acc = _conv(xf, wf, None, a).float().double()
            if bias is not None:
                acc = acc + bias.double().reshape(1, -1, 1, 1)
            yf = acc * (_scalar(xs) * ws.double()).reshape(1, -1, 1, 1)
            y = torch.clamp(torch.round(yf / tensor_scalar(ys, torch.float64)
                                        + int(_scalar(yzp))), 0, 255).to(torch.uint8)
        elif op == 'QuantizeLinear':
            y = torch.clamp(torch.round(x[0] / tensor_scalar(x[1], torch.float32)
                                        + int(_scalar(x[2]))), 0, 255).to(torch.uint8)
        elif op == 'DequantizeLinear':
            y = (x[0].float() - int(_scalar(x[2]))) * tensor_scalar(x[1], torch.float32)
        elif op == 'Relu':
            y = torch.clamp_min(x[0], 0)
        elif op == 'LeakyRelu':
            y = torch.where(x[0] > 0, x[0], a.get('alpha', 0.01) * x[0])
        elif op == 'Clip':
            y = torch.clamp(x[0], _scalar(x[1]), _scalar(x[2]))
        elif op == 'Sigmoid':
            y = 1.0 / (1.0 + torch.exp(-x[0]))
        elif op == 'Tanh':
            y = torch.tanh(x[0])
        elif op == 'Exp':
            y = torch.exp(x[0])
        elif op == 'Add':
            y = x[0] + x[1]
        elif op == 'Sub':
            y = x[0] - x[1]
        elif op == 'Mul':
            y = x[0] * x[1]
        elif op == 'Concat':
            y = torch.cat(x, dim=a['axis'])
        elif op == 'Reshape':
            y = x[0].reshape([int(d) for d in x[1].tolist()])
        elif op == 'Transpose':
            y = x[0].permute(*a['perm'])
        elif op == 'Split':
            sizes = [int(s) for s in x[1].tolist()]
            for name, arr in zip(n['output'], torch.split(x[0], sizes, dim=a['axis'])):
                env[name] = arr
            continue
        elif op == 'MaxPool':
            k = a['kernel_shape']
            p = a.get('pads', [0] * 4)
            xp = F.pad(x[0], (p[1], p[1], p[0], p[0]), value=float('-inf'))
            y = F.max_pool2d(xp, tuple(k), tuple(a.get('strides', [1, 1])))
        elif op == 'GlobalAveragePool':
            y = x[0].mean(dim=(2, 3), keepdim=True)
        elif op == 'Resize':
            fh, fw = int(x[2][2]), int(x[2][3])
            y = x[0].repeat_interleave(fh, dim=2).repeat_interleave(fw, dim=3)
        elif op == 'Flatten':
            y = x[0].reshape(x[0].shape[0], -1)
        elif op == 'Gemm':
            y = x[0] @ x[1] + x[2]
        else:
            raise NotImplementedError(op)
        env[n['output'][0]] = y

    return [env[vi['name']] for vi in g['output']]
