"""ONNX exporters: fp and quantized detection graphs from the port's trees
(the port of ``pqdet_tpu/exporters/onnx_export.py``).

- ``export_normal_to_onnx``: the fp model with the YOLO decode emitted as
  raw ONNX nodes, from the BN-folded params of ``fuse_params`` /
  ``inference_params`` (conv weights OIHW tensors);
- ``export_quantized_to_onnx``: the hand-built QuantizeLinear /
  QLinearConv / DequantizeLinear graph from the output of the port's
  ``convert_to_int8`` (``wq`` int8 OIHW, ``w_scale``, ``b``, ``act``), with
  add/concat/pool as dequant-op-quant sandwiches and upsample as Resize.

The graphs are NCHW, as ONNX has them. The port's conv weights are OIHW
already, so the JAX module's HWIO -> OIHW transpose is gone; every other
step (name counters, node and initializer order, dtypes, the int32 bias
rounding) is the JAX module's, and the same weights give the same bytes.
Serialization is ``onnx_proto.py``, with no onnx package.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from pqdet_tpu_torch.exporters import onnx_proto as P
from pqdet_tpu_torch.model.graph import Graph, solve_padding


def _host(t, dtype) -> np.ndarray:
    """A tensor (or array) as a contiguous numpy array of ``dtype``."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(t, dtype))


class _GraphBuilder:
    def __init__(self):
        self.nodes: List[Dict] = []
        self.inits: List[Dict] = []
        self._n = 0

    def name(self, hint: str) -> str:
        self._n += 1
        return f'{hint}_{self._n}'

    def const(self, hint: str, arr: np.ndarray) -> str:
        name = self.name(hint)
        self.inits.append(P.tensor(name, np.asarray(arr)))
        return name

    def add(self, op: str, inputs: List[str], hint: str = '',
            n_out: int = 1, **attrs) -> List[str]:
        outs = [self.name(hint or op.lower()) for _ in range(n_out)]
        self.nodes.append(P.node(op, inputs, outs,
                                 name=self.name(op.lower()), **attrs))
        return outs


def _activation(g: _GraphBuilder, act: str, x: str) -> str:
    if act in ('linear', 'none'):
        return x
    if act == 'relu':
        return g.add('Relu', [x])[0]
    if act == 'relu6':
        lo = g.const('zero', np.float32(0.0))
        hi = g.const('six', np.float32(6.0))
        return g.add('Clip', [x, lo, hi])[0]
    if act == 'leaky':
        return g.add('LeakyRelu', [x], alpha=0.1)[0]
    if act == 'logistic':
        return g.add('Sigmoid', [x])[0]
    if act == 'tanh':
        return g.add('Tanh', [x])[0]
    raise ValueError(f'activation {act} not exportable')


def _decode_nodes(g: _GraphBuilder, conv_out: str, b: int, h: int, w: int,
                  a: int, nc: int, stride: int) -> str:
    """YOLO decode as raw ONNX nodes: -> (B, H*W*A, 5+nc) in input-image
    pixel coordinates."""
    nhwc = g.add('Transpose', [conv_out], 'nhwc', perm=[0, 2, 3, 1])[0]
    shp = g.const('shape', np.array([b, h, w, a, 5 + nc], np.int64))
    raw = g.add('Reshape', [nhwc, shp], 'raw5d')[0]
    split = g.const('split_sizes', np.array([2, 2, 1, nc], np.int64))
    d1, d2, conf, prob = g.add('Split', [raw, split], 'part', n_out=4, axis=4)

    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32) + 0.5
    grid = g.const('grid', np.stack([xs, ys], -1).reshape(1, h, w, 1, 2))
    s = g.const('stride', np.float32(stride))
    xymin = g.add('Mul', [g.add('Sub', [grid, g.add('Exp', [d1])[0]])[0], s],
                  'xymin')[0]
    xymax = g.add('Mul', [g.add('Add', [grid, g.add('Exp', [d2])[0]])[0], s],
                  'xymax')[0]
    conf = g.add('Sigmoid', [conf])[0]
    prob = g.add('Sigmoid', [prob])[0]
    cat = g.add('Concat', [xymin, xymax, conf, prob], 'decoded', axis=4)[0]
    flat = g.const('flatshape', np.array([b, h * w * a, 5 + nc], np.int64))
    return g.add('Reshape', [cat, flat], 'head')[0]


def _conv_out(hw, size: int, stride: int, padding: int):
    return tuple((d + 2 * padding - size) // stride + 1 for d in hw)


def export_normal_to_onnx(network, fused_params: Dict, input_size,
                          batch_size: int = 1) -> bytes:
    """fp inference graph -> serialized ONNX ModelProto bytes.

    fused_params: BN-folded params (``fuse_params`` / ``inference_params``;
    conv ``w`` OIHW, fc ``w`` (out, in)), on any device. Output 'preds':
    (B, sum H*W*A, 5+num_classes), the semantics of the inference walk.
    """
    graph: Graph = network.graph
    h0, w0 = input_size
    g = _GraphBuilder()
    heads: List[str] = []
    # value name + NCHW shape per node index
    val: Dict[int, str] = {}
    shape: Dict[int, tuple] = {}

    cur, cur_shape = 'input', (batch_size, 3, h0, w0)
    for node in graph.nodes:
        i, kind, a = node.index, node.kind, node.attrs
        p = fused_params.get(str(i), {})
        if kind == 'convolutional':
            padding = solve_padding(a['size'], a['padding'], a['pad'])
            wf = _host(p['w'], np.float32)
            # the group from the weight shape, as the JAX exporter reads it
            group = node.in_channels // wf.shape[1]
            wn = g.const(f'w{i}', wf)
            bn = g.const(f'b{i}', _host(p['b'], np.float32) if 'b' in p
                         else np.zeros(node.out_channels, np.float32))
            y = g.add('Conv', [cur, wn, bn], f'conv{i}',
                      strides=[a['stride']] * 2, group=group,
                      kernel_shape=[a['size']] * 2, pads=[padding] * 4)[0]
            y = _activation(g, a['activation'], y)
            n_, _, h_, w_ = cur_shape
            cur, cur_shape = y, (n_, node.out_channels,
                                 *_conv_out((h_, w_), a['size'], a['stride'], padding))
        elif kind == 'shortcut':
            y = g.add('Add', [cur, val[node.refs[0]]], f'short{i}')[0]
            cur = _activation(g, a['activation'], y)
        elif kind == 'scale_channels':
            cur = g.add('Mul', [val[node.refs[0]], cur], f'scale{i}')[0]
            cur_shape = shape[node.refs[0]]
        elif kind == 'route':
            if len(node.refs) == 1:
                cur, cur_shape = val[node.refs[0]], shape[node.refs[0]]
            else:
                cur = g.add('Concat', [val[r] for r in node.refs],
                            f'route{i}', axis=1)[0]
                n_, _, h_, w_ = shape[node.refs[0]]
                cur_shape = (n_, node.out_channels, h_, w_)
        elif kind == 'maxpool':
            padding = solve_padding(a['size'], a['padding'], a['pad'])
            cur = g.add('MaxPool', [cur], f'max{i}',
                        kernel_shape=[a['size']] * 2,
                        strides=[a['stride']] * 2, pads=[padding] * 4)[0]
            n_, c_, h_, w_ = cur_shape
            cur_shape = (n_, c_, *_conv_out((h_, w_), a['size'], a['stride'], padding))
        elif kind == 'avgpool':
            if tuple(node.out_size) != (1, 1):
                raise ValueError('only global avgpool exports')
            cur = g.add('GlobalAveragePool', [cur], f'avg{i}')[0]
            cur_shape = (cur_shape[0], cur_shape[1], 1, 1)
        elif kind == 'upsample':
            f = a['stride']
            scales = g.const('scales', np.array([1, 1, f, f], np.float32))
            cur = g.add('Resize', [cur, '', scales], f'up{i}',
                        mode='nearest')[0]
            n_, c_, h_, w_ = cur_shape
            cur_shape = (n_, c_, h_ * f, w_ * f)
        elif kind == 'fc':
            flat = g.add('Flatten', [cur], f'flat{i}', axis=1)[0]
            # Gemm computes x @ w: the (in, out) weight of the JAX tree
            wn = g.const(f'w{i}', np.ascontiguousarray(_host(p['w'], np.float32).T))
            bn = g.const(f'b{i}', _host(p['b'], np.float32))
            y = g.add('Gemm', [flat, wn, bn], f'fc{i}')[0]
            cur = _activation(g, a['activation'], y)
            cur_shape = (cur_shape[0], node.out_channels)
        elif kind == 'yolo':
            n_, c_, h_, w_ = cur_shape
            anchors = c_ // (5 + a['classes'])
            heads.append(_decode_nodes(g, cur, n_, h_, w_, anchors,
                                       a['classes'], a['stride']))
        elif kind == 'dropout':
            pass
        else:
            raise ValueError(kind)
        val[i], shape[i] = cur, cur_shape

    nc = next(n.attrs['classes'] for n in graph.nodes if n.kind == 'yolo')
    out = g.add('Concat', heads, 'preds', axis=1)[0] if len(heads) > 1 \
        else heads[0]
    # the JAX package's doc strings: the port writes its bytes
    m = P.model(
        'pqdet', g.nodes,
        inputs=[P.value_info('input', P.FLOAT,
                             [batch_size, 3, h0, w0])],
        outputs=[P.value_info(out, P.FLOAT, [batch_size, None, 5 + nc])],
        initializers=g.inits,
        doc='pqdet_tpu fp export (reference convert.py:58-69)')
    P.check_model(m)
    return P.encode_model(m)


# ------------------------------------------------------------- quantized

def _qdq(g: _GraphBuilder, x: str, scale: float, zp: int,
         hint: str = 'q') -> str:
    """QuantizeLinear to u8."""
    s = g.const('qs', np.float32(scale))
    z = g.const('qz', np.uint8(zp))
    return g.add('QuantizeLinear', [x, s, z], hint)[0]


def _dq(g: _GraphBuilder, x: str, scale: float, zp: int,
        hint: str = 'dq') -> str:
    s = g.const('dqs', np.float32(scale))
    z = g.const('dqz', np.uint8(zp))
    return g.add('DequantizeLinear', [x, s, z], hint)[0]


def export_quantized_to_onnx(network, qparams: Dict, input_size,
                             batch_size: int = 1) -> bytes:
    """int8 model (``convert_to_int8`` or ``load_quantized``) ->
    serialized ONNX bytes.

    QuantizeLinear at the input, one QLinearConv per conv on a quantized
    edge (per-output-channel weight scales, int32 bias at scale
    x_scale*w_scale), dequant-op-quant sandwiches for
    add/mul/concat/pool/upsample, DequantizeLinear before the fp yolo
    decode chain. Activations on quantized edges are realised by the
    requant saturation (observers record post-activation ranges; relu
    with zero point 0 clamps exactly), as the int8 executor does. A grouped
    conv is one QLinearConv with ``group=G`` and its original grouped
    weights, though ``Int8Inference`` serves it densified.
    """
    graph: Graph = network.graph
    layers, act = qparams['layers'], qparams['act']
    h0, w0 = input_size
    g = _GraphBuilder()
    heads: List[str] = []
    val: Dict[int, str] = {}
    qp: Dict[int, Optional[tuple]] = {}    # quantized edge params per node
    shape: Dict[int, tuple] = {}

    in_scale, in_zp = act['input']
    cur = _qdq(g, 'input', in_scale, int(round(in_zp)), 'input_q')
    cur_qp = (in_scale, int(round(in_zp)))
    cur_shape = (batch_size, 3, h0, w0)

    def dequant_cur():
        return _dq(g, cur, cur_qp[0], cur_qp[1]) if cur_qp else cur

    for node in graph.nodes:
        i, kind, a = node.index, node.kind, node.attrs
        key = str(i)
        p = layers.get(key, {})
        out_edge = act.get(key)
        if kind == 'convolutional':
            padding = solve_padding(a['size'], a['padding'], a['pad'])
            wq = _host(p['wq'], np.int8)
            w_scale = _host(p['w_scale'], np.float32)
            b = _host(p['b'], np.float32)
            n_, _, h_, w_ = cur_shape
            oh, ow = _conv_out((h_, w_), a['size'], a['stride'], padding)
            if cur_qp is not None and out_edge is not None:
                xs, xzp = cur_qp
                bias_q = np.round(b / (xs * w_scale)).astype(np.int32)
                os_, ozp = out_edge[0], int(round(out_edge[1]))
                y = g.add('QLinearConv', [
                    cur,
                    g.const('xs', np.float32(xs)),
                    g.const('xz', np.uint8(xzp)),
                    g.const(f'w{i}', wq),
                    g.const(f'ws{i}', w_scale),
                    g.const(f'wz{i}', np.zeros(len(w_scale), np.int8)),
                    g.const('ys', np.float32(os_)),
                    g.const('yz', np.uint8(ozp)),
                    g.const(f'bias{i}', bias_q),
                ], f'qconv{i}', strides=[a['stride']] * 2, group=a['groups'],
                    kernel_shape=[a['size']] * 2, pads=[padding] * 4)[0]
                # activation is realised by requant saturation: observers
                # record post-activation ranges; for relu/relu6 with zp 0
                # the [0,255] clamp is exact. leaky/linear need explicit fp.
                if a['activation'] not in ('relu', 'relu6', 'linear', 'none'):
                    raise ValueError(
                        f'quantized conv {i} has activation '
                        f'{a["activation"]}; QAT graphs use relu-family')
                cur, cur_qp = y, (os_, ozp)
            else:
                # fp conv (edge feeding a yolo head, or fp input edge)
                x = dequant_cur()
                wf = wq.astype(np.float32) * w_scale.reshape(-1, 1, 1, 1)
                y = g.add('Conv', [x, g.const(f'w{i}', wf),
                                   g.const(f'b{i}', b)], f'conv{i}',
                          strides=[a['stride']] * 2, group=a['groups'],
                          kernel_shape=[a['size']] * 2, pads=[padding] * 4)[0]
                y = _activation(g, a['activation'], y)
                if out_edge is not None:
                    os_, ozp = out_edge[0], int(round(out_edge[1]))
                    cur, cur_qp = _qdq(g, y, os_, ozp), (os_, ozp)
                else:
                    cur, cur_qp = y, None
            cur_shape = (n_, node.out_channels, oh, ow)
        elif kind in ('shortcut', 'scale_channels', 'route', 'maxpool',
                      'avgpool', 'upsample'):
            # dequant-op-quant sandwich
            if kind == 'shortcut':
                rhs = val[node.refs[0]]
                rq = qp[node.refs[0]]
                rhs = _dq(g, rhs, rq[0], rq[1]) if rq else rhs
                y = g.add('Add', [dequant_cur(), rhs], f'short{i}')[0]
                y = _activation(g, a['activation'], y)
            elif kind == 'scale_channels':
                lhs = val[node.refs[0]]
                lq = qp[node.refs[0]]
                lhs = _dq(g, lhs, lq[0], lq[1]) if lq else lhs
                y = g.add('Mul', [lhs, dequant_cur()], f'scale{i}')[0]
                cur_shape = shape[node.refs[0]]
            elif kind == 'route':
                srcs = []
                for r in node.refs:
                    s = val[r]
                    srcs.append(_dq(g, s, qp[r][0], qp[r][1]) if qp[r] else s)
                y = srcs[0] if len(srcs) == 1 else \
                    g.add('Concat', srcs, f'route{i}', axis=1)[0]
                n_, _, h_, w_ = shape[node.refs[0]]
                cur_shape = (n_, node.out_channels, h_, w_)
            elif kind == 'maxpool':
                padding = solve_padding(a['size'], a['padding'], a['pad'])
                y = g.add('MaxPool', [dequant_cur()], f'max{i}',
                          kernel_shape=[a['size']] * 2,
                          strides=[a['stride']] * 2, pads=[padding] * 4)[0]
                n_, c_, h_, w_ = cur_shape
                cur_shape = (n_, c_, *_conv_out((h_, w_), a['size'], a['stride'], padding))
            elif kind == 'avgpool':
                y = g.add('GlobalAveragePool', [dequant_cur()], f'avg{i}')[0]
                cur_shape = (cur_shape[0], cur_shape[1], 1, 1)
            else:  # upsample
                f = a['stride']
                scales = g.const('scales', np.array([1, 1, f, f], np.float32))
                y = g.add('Resize', [dequant_cur(), '', scales], f'up{i}',
                          mode='nearest')[0]
                n_, c_, h_, w_ = cur_shape
                cur_shape = (n_, c_, h_ * f, w_ * f)
            if out_edge is not None:
                os_, ozp = out_edge[0], int(round(out_edge[1]))
                cur, cur_qp = _qdq(g, y, os_, ozp), (os_, ozp)
            else:
                cur, cur_qp = y, None
        elif kind == 'yolo':
            x = dequant_cur()
            n_, c_, h_, w_ = cur_shape
            anchors = c_ // (5 + a['classes'])
            heads.append(_decode_nodes(g, x, n_, h_, w_, anchors,
                                       a['classes'], a['stride']))
        elif kind == 'dropout':
            pass
        else:
            raise ValueError(f'{kind} not supported in quantized export')
        val[i], qp[i], shape[i] = cur, cur_qp, cur_shape

    nc = next(n.attrs['classes'] for n in graph.nodes if n.kind == 'yolo')
    out = g.add('Concat', heads, 'preds', axis=1)[0] if len(heads) > 1 \
        else heads[0]
    m = P.model(
        'pqdet_quant', g.nodes,
        inputs=[P.value_info('input', P.FLOAT, [batch_size, 3, h0, w0])],
        outputs=[P.value_info(out, P.FLOAT, [batch_size, None, 5 + nc])],
        initializers=g.inits,
        doc='pqdet_tpu quantized export '
            '(reference export/onnx_exporter.py:33-398)')
    P.check_model(m)
    return P.encode_model(m)
