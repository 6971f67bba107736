"""Int8 quantized inference (the port of ``pqdet_tpu/compress/quantized.py``).

BN-folded conv weights are quantised to per-output-channel symmetric int8
and activations to per-tensor affine uint8 with the QAT observers' ranges;
every quantised edge is requantised. Add, concat and scale run in f32
between a dequant and a requant, as in the JAX package.

``Int8Inference`` walks the quant graph in one of three modes:

- ``'kernel'`` (the JAX package's ``'pallas'``): activations in the
  recentred s8 form, every pointwise conv through ``qconv1x1_s8`` (a
  strided one on the input's every stride-th pixel, where the JAX package
  runs its bf16 dequant conv), every depthwise 3x3 through
  ``qdwconv3x3_s8`` (both CUDA kernels on the card, ``csrc/qconv.cu``),
  and the dense 3x3 stem and the densified grouped 3x3s
  (``prepare(network=)``, K = 9 * Cin up to 4752) as im2col patches into
  ``qconv1x1_s8``; the raw yolo heads are decoded after the walk by one
  launch of the Triton decode kernel into the preds. This is the serving
  path;
- ``'int'``: uint8 activations and ``int8_conv``, the exact integer
  reference, plain PyTorch (the sum in float64: torch has no integer
  conv);
- ``'dequant'``: int8 weight storage dequantised at use and activations
  fake-quantised per edge, with a bf16 conv.

Conv weights are OIHW (``wq`` (O, I, 3, 3) int8), as everywhere in the
port; ``bridge.from_jax_qparams`` carries the JAX package's HWIO across.
``save_quantized`` and ``load_quantized`` write and read 'quant'
checkpoints in the JAX package's layout, so a converted model crosses
both ways.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pqdet_tpu_torch.bridge import from_jax_qparams, to_jax_qparams
from pqdet_tpu_torch.compress.qat import act_qparams, ieee_div
from pqdet_tpu_torch.model import layers as L
from pqdet_tpu_torch.model.graph import solve_padding
from pqdet_tpu_torch.model.network import (DetectionNetwork, decode_all_heads,
                                           decode_consumed_head, fuse_params)
from pqdet_tpu_torch.ops.decode_kernel import head_views
from pqdet_tpu_torch.ops.qconv import (make_scalars, qconv1x1_reference,
                                       qconv1x1_s8, qdwconv3x3_reference,
                                       qdwconv3x3_s8)
from pqdet_tpu_torch.utils import tracing
from pqdet_tpu_torch.utils.codec import load_checkpoint, save_pytrees

# widest dense 3x3 input the JAX package stages for its integer-exact
# paths (Int8Inference.prepare, quantized.py:564-565); densified grouped
# 3x3s take the im2col route at any width (their sums are exact in s32:
# K * 127 * 127 < 2^31 up to K = 133,000)
MAX_DENSE_CIN = 115
# group widths (input channels per group) that ``prepare(network=)``
# densifies, the JAX package's range
DENSE_GROUP_WIDTHS = (2, 115)


def im2col_depth(cin: int) -> int:
    """K of the stem's im2col patches: 9 * Cin rounded up to 16 with zero
    columns (27 -> 32 for RGB), so each patch row is whole 16-byte copies
    for the 1x1 kernel. The zero columns meet zero weight rows: the
    integer sum and colsum are unchanged."""
    return -(-9 * cin // 16) * 16


def quantize_weights(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """OIHW f32 -> (int8 OIHW, per-out-channel f32 scale)."""
    absmax = torch.amax(torch.abs(w), dim=(1, 2, 3), keepdim=True)
    scale = torch.clamp_min(ieee_div(absmax, 127.0), 1e-8)   # IEEE on the card too
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale.reshape(-1).float()


def convert_to_int8(network: DetectionNetwork, params: Dict, state: Dict) -> Dict:
    """QAT params + state -> int8 inference params.

    Returns {'layers': {idx: {'wq', 'w_scale', 'b'}}, 'act': {edge: (scale,
    zp)}}, the tensors on the params' device, the edge qparams as Python
    floats."""
    if 'quant' not in state:
        raise ValueError('state has no quant observers; calibrate with '
                         'prepare_qat_state and QuantCtx passes first')
    fused = fuse_params(network, params, state)
    layers = {}
    for node in network.graph.nodes:
        key = str(node.index)
        if key not in fused:
            continue
        p = fused[key]
        if node.kind == 'convolutional':
            wq, w_scale = quantize_weights(p['w'].float())
            b = p.get('b')
            if b is None:
                b = torch.zeros(wq.shape[0], dtype=torch.float32, device=wq.device)
            layers[key] = {'wq': wq, 'w_scale': w_scale, 'b': b.float()}
        else:
            layers[key] = dict(p)
    act = {}
    for edge, obs in state['quant'].items():
        scale, zp = act_qparams(obs)
        act[edge] = (float(scale), float(zp))
    return {'layers': layers, 'act': act}


def save_quantized(path: str, network: DetectionNetwork, qparams: Dict, cfg_text: str,
                   step: int = 0, ap=None):
    """Write int8 ``qparams`` as a 'quant' checkpoint in the JAX package's
    layout (``params``: the layers of ``bridge.to_jax_qparams``; ``state``:
    ``act``, each edge's (scale, zero point) as a (2,) f32 array), which
    JAX's ``load_quantized`` reads."""
    jq = to_jax_qparams(qparams, network.graph)
    act = {k: np.asarray(v, np.float32) for k, v in jq['act'].items()}
    save_pytrees(path, jq['layers'], {'act': act}, step=step, cfg_text=cfg_text, ap=ap,
                 ckpt_type='quant', backend='int8')


def load_quantized(path: str, device='cuda'):
    """A 'quant' checkpoint (of either package) -> (quant-graph network, int8
    qparams on ``device``)."""
    ckpt = load_checkpoint(path)
    if ckpt.get('type') != 'quant':
        raise ValueError(f'{path} is not a quantized checkpoint')
    network = DetectionNetwork.from_cfg(ckpt['cfg'], quant=True)
    qparams = from_jax_qparams({'layers': ckpt['params'], 'act': ckpt['state']['act']},
                               network.graph, device=device)
    return network, qparams


def _quant(x, scale_zp):
    scale, zp = scale_zp
    return torch.clamp(torch.round(x / scale + zp), 0, 255).to(torch.uint8)


def _dequant(q, scale_zp):
    scale, zp = scale_zp
    return (q.float() - zp) * scale


def _quant_s8(x, scale_zp):
    """Affine-quantise to the RECENTRED signed form s = q_u8 - 128, which the
    int8 kernels take and give, so no layer needs a recentre op."""
    scale, zp = scale_zp
    return torch.clamp(torch.round(x / scale + (zp - 128.0)), -128, 127).to(torch.int8)


def _dequant_s8(s, scale_zp):
    scale, zp = scale_zp
    return (s.float() - (zp - 128.0)) * scale


def _fake_quant_edge(x, scale_zp):
    """Quantise-dequantise in f32 without materialising uint8."""
    scale, zp = scale_zp
    q = torch.clamp(torch.round(x / scale + zp), 0, 255)
    return (q - zp) * scale


def int8_conv(xq: torch.Tensor, x_scale_zp, wq: torch.Tensor, w_scale, b,
              stride: int, padding: int, groups: int) -> torch.Tensor:
    """Quantized conv of uint8 NHWC ``xq`` with int8 OIHW ``wq``, returning
    f32 NHWC: the integer reference.

    The uint8 activation is recentred to s8 by subtracting 128, padding uses
    the recentred zero point (real value 0), and the combined offset is
    removed analytically:
        conv(x_q - zp, w) = conv(x_q - 128, w) + (128 - zp) * sum(w)
    The integer conv runs in float64, which is exact here (PyTorch has no
    integer conv); the sum is then rounded to f32 and scaled, as the JAX
    package's s32 accumulator."""
    x_scale, x_zp = x_scale_zp
    zp = int(round(float(x_zp)))
    xs = xq.to(torch.float64) - 128.0
    if padding:
        xs = F.pad(xs.permute(0, 3, 1, 2), (padding,) * 4, value=float(zp - 128))
    else:
        xs = xs.permute(0, 3, 1, 2)
    # contiguous NHWC, as every conv of the walk returns (the decode kernel
    # takes contiguous heads only)
    acc = F.conv2d(xs, wq.double(), None, stride, 0, 1, groups).permute(0, 2, 3, 1).contiguous()
    w_sum = wq.to(torch.float64).sum(dim=(1, 2, 3))  # per out channel
    acc = acc + (128 - zp) * w_sum
    return acc.float() * (x_scale * w_scale) + b


def _stem_im2col(xq, stride: int, pad_val: int):
    """3x3 patches of recentred s8 ``xq`` (padding 1 with ``pad_val``), in
    (kh, kw, cin) channel order, then zero columns up to
    ``im2col_depth(Cin)``: (N, H/stride, W/stride, im2col_depth(Cin)) int8."""
    n, h, w, c = xq.shape
    xp = torch.full((n, h + 2, w + 2, c), pad_val, dtype=torch.int8, device=xq.device)
    xp[:, 1:-1, 1:-1] = xq
    ho, wo = h // stride, w // stride
    cols = [xp[:, kh:kh + stride * ho:stride, kw:kw + stride * wo:stride]
            for kh in range(3) for kw in range(3)]
    extra = im2col_depth(c) - 9 * c
    if extra:
        cols.append(xq.new_zeros((n, ho, wo, extra)))
    return torch.cat(cols, dim=-1)


class Int8Inference:
    """Quantized graph executor (inference only, NHWC int8 tensors).

    ``mode``: ``'kernel'`` (default), ``'int'`` or ``'dequant'`` (module
    docstring). Run ``Int8Inference.prepare`` on the qparams first: it
    derives the kernels' weight views once.
    """

    MODES = ('kernel', 'int', 'dequant')

    def __init__(self, network: DetectionNetwork, mode: str = 'kernel'):
        if mode not in self.MODES:
            raise ValueError(f'mode must be one of {self.MODES}, got {mode!r}')
        self.network = network
        self.graph = network.graph
        self.mode = mode
        self._scalars: Dict[tuple, torch.Tensor] = {}

    @staticmethod
    def prepare(qparams: Dict, mode: str = 'kernel', network: DetectionNetwork = None) -> Dict:
        """Derive the kernel weight views (``'kernel'`` mode), contiguous on
        the weights' device:
        - 1x1 conv: ``w2d`` (Cin, Cout) int8 and ``colsum`` (Cout,) int32;
        - depthwise 3x3 (one input channel per group): ``wdw`` (3, 3, C);
        - dense 3x3 with Cin <= 115: ``wim`` (im2col_depth(Cin), Cout) in
          (kh, kw, cin) order with zero rows after the 9*Cin taps, and
          ``wim_colsum``, for the im2col route into the 1x1 kernel.
        With ``network`` given, a GROUPED conv of group width 2-115 (the
        RegNet pattern) whose Cout is a multiple of its groups is first
        densified to block-diagonal int8 weights
        (``layers.densify_grouped_weight``, the JAX package's
        ``_densify_int8_weight``), as its ``prepare(network=)`` does: a
        grouped 1x1 becomes ``w2d`` and ``colsum``, a grouped 3x3 a dense
        3x3 whose ``wim`` is staged at any Cin (K up to 9 * 528 = 4752 in
        the zoo). Without it the views are of the compact weights, which
        the walk admits for no input: such a conv runs the bf16 dequant
        conv on the CPU, as in JAX, and kernel mode raises on the card.
        ``wq`` stays grouped. Other modes stage the qparams as they are."""
        groups_of = {} if network is None else {
            str(n.index): n.attrs['groups'] for n in network.graph.nodes
            if n.kind == 'convolutional'}
        layers = {}
        for key, p in qparams['layers'].items():
            p = dict(p)
            wq = p.get('wq') if mode == 'kernel' else None
            if wq is not None:
                g = groups_of.get(key, 1)
                densified = (g > 1 and DENSE_GROUP_WIDTHS[0] <= wq.shape[1]
                             <= DENSE_GROUP_WIDTHS[1] and wq.shape[0] % g == 0)
                if densified:
                    wq = L.densify_grouped_weight(wq, g)
                cout, cin, kh, kw = wq.shape
                if (kh, kw) == (1, 1):
                    p['w2d'] = wq.reshape(cout, cin).t().contiguous()
                    p['colsum'] = p['w2d'].to(torch.int32).sum(0).to(torch.int32)
                elif (cin, kh, kw) == (1, 3, 3):
                    p['wdw'] = wq.reshape(cout, 9).t().reshape(3, 3, cout).contiguous()
                elif (kh, kw) == (3, 3) and (cin <= MAX_DENSE_CIN or densified):
                    wim = wq.permute(2, 3, 1, 0).reshape(9 * cin, cout)
                    p['wim'] = F.pad(wim, (0, 0, 0, im2col_depth(cin) - 9 * cin)).contiguous()
                    p['wim_colsum'] = p['wim'].to(torch.int32).sum(0).to(torch.int32)
            layers[key] = {k: v.contiguous() if isinstance(v, torch.Tensor) else v
                           for k, v in p.items()}
        return {'layers': layers, 'act': qparams['act']}

    def _scalar_vector(self, key, x_sz, out_edge, device):
        """The kernels' (1, 4) scalar vector of conv ``key``, made once per
        edge qparams and device (the JAX package bakes it into the jitted
        program as a constant)."""
        k = (key, x_sz, out_edge, str(device))
        sc = self._scalars.get(k)
        if sc is None:
            sc = make_scalars(x_sz[0], x_sz[1],
                              None if out_edge is None else out_edge[0],
                              None if out_edge is None else out_edge[1], device)
            self._scalars[k] = sc
        return sc

    def apply(self, qparams: Dict, x: torch.Tensor, intermediates: bool = False,
              plain: bool = False, kernels=None):
        """Run the quantized graph on normalized NHWC f32 ``x``; returns
        (B, sum HWA, 5+C) f32 preds. With ``intermediates`` the return value
        is ``(preds, {node_key: f32 node output})``, the per-layer view the
        kernel path is held to; a yolo node's entry is its (B, H, W, A, 5+C)
        view of the preds. ``plain`` runs the kernels' plain versions
        on any device. ``kernels`` (``ops.library.Kernels``: the 1x1, the
        depthwise and the decode entry, with the wrappers' signatures)
        replaces the wrappers: an exported program walks with
        ``ops.library.OPS``, the registered operators."""
        act = qparams['act']
        layers = qparams['layers']
        cache: Dict[int, tuple] = {}
        inter: Dict[str, torch.Tensor] = {}
        heads = []                       # (raw f32 head, yolo node)
        kernel = self.mode == 'kernel'
        if kernels is not None:
            pw_fn, dw_fn, dec_fn = kernels
        else:
            pw_fn = qconv1x1_reference if plain else qconv1x1_s8
            dw_fn = qdwconv3x3_reference if plain else qdwconv3x3_s8
            dec_fn = None

        def as_fp(val, sz):
            if sz is None:
                return val
            return _dequant_s8(val, sz) if kernel else _dequant(val, sz)

        def requant(y, sz):
            if self.mode == 'dequant':
                return _fake_quant_edge(y, sz), None
            return (_quant_s8(y, sz), sz) if kernel else (_quant(y, sz), sz)

        def edge(key, y):
            if key in act:  # requantise this edge
                return requant(y, act[key])
            return y, None  # f32 edge (feeds a yolo head)

        # spans (utils/tracing.py): int8.sandwich around a quantisation or a
        # node's dequant, f32 op and requant; int8.im2col, int8.kernel and
        # int8.decode around the patches, the int8 kernels and the decode
        with tracing.span('int8.sandwich'):
            xq, cur_sz = requant(x, act['input'])

        for node in self.graph.nodes:
            i, kind = node.index, node.kind
            key = str(i)
            a = node.attrs
            if kind == 'dropout':
                continue
            if kind == 'convolutional':
                p = layers[key]
                padding = solve_padding(a['size'], a['padding'], a['pad'])
                stride = a['stride']
                _, h, w, c = xq.shape
                even = h % stride == 0 and w % stride == 0
                dw_ok = ('wdw' in p and a['size'] == 3 and padding == 1
                         and a['groups'] == c and a['groups'] == a['filters'] and even)
                # a strided 1x1 (the RegNets' projections) is the 1x1 of
                # the input's every stride-th row and column
                pw_ok = 'w2d' in p and padding == 0 and p['w2d'].shape[0] == c
                im2col_ok = ('wim' in p and a['size'] == 3 and padding == 1
                             and stride in (1, 2) and p['wim'].shape[0] == im2col_depth(c)
                             and even)
                if kernel and cur_sz is not None and (pw_ok or dw_ok or im2col_ok):
                    out_edge = act.get(key)
                    common = dict(act=a['activation'], requant=out_edge is not None,
                                  scalars=self._scalar_vector(key, cur_sz, out_edge,
                                                              xq.device))
                    if pw_ok:
                        xs = xq
                        if stride != 1:
                            with tracing.span('int8.im2col'):
                                xs = xq[:, ::stride, ::stride].contiguous()
                        with tracing.span('int8.kernel'):
                            y = pw_fn(xs, p['w2d'], p['w_scale'], p['b'], p['colsum'],
                                      **common)
                    elif dw_ok:
                        with tracing.span('int8.kernel'):
                            y = dw_fn(xq, p['wdw'], p['w_scale'], p['b'], stride=stride,
                                      **common)
                    else:
                        with tracing.span('int8.im2col'):
                            patches = _stem_im2col(xq, stride, round(cur_sz[1]) - 128)
                        with tracing.span('int8.kernel'):
                            y = pw_fn(patches, p['wim'], p['w_scale'], p['b'],
                                      p['wim_colsum'], **common)
                    xq, cur_sz = y, out_edge
                    self._keep(i, xq, cur_sz, cache, inter, intermediates, as_fp)
                    continue
                if kernel and not plain and xq.device.type != 'cpu':
                    # off the CPU the kernel path runs its kernels or raises;
                    # the JAX package's bf16 dequant conv stays the CPU's
                    # and the plain walk's
                    raise ValueError(
                        f'Int8Inference kernel mode: conv {key} (size {a["size"]}, '
                        f'stride {stride}, groups {a["groups"]}, input {tuple(xq.shape)}, '
                        f'quantised input {cur_sz is not None}) fits neither int8 kernel')
                if self.mode == 'int':
                    y = int8_conv(xq, cur_sz, p['wq'], p['w_scale'], p['b'],
                                  stride, padding, a['groups'])
                else:
                    wf = p['wq'].float() * p['w_scale'][:, None, None, None]
                    y = L.conv2d(as_fp(xq, cur_sz), wf, p['b'], stride=stride,
                                 padding=padding, groups=a['groups'],
                                 compute_dtype=torch.bfloat16).float()
                y = L.apply_activation(a['activation'], y)
                with tracing.span('int8.sandwich'):
                    xq, cur_sz = edge(key, y)
            elif kind == 'upsample':
                # replication commutes with quantisation: stay int8
                xq = L.upsample_nearest(xq, a['stride'])
            elif kind == 'yolo':
                xq, cur_sz = as_fp(xq, cur_sz), None
                heads.append((xq, node))
                if i in self.graph.last_use:
                    with tracing.span('int8.decode'):
                        xq = decode_consumed_head(xq, node, plain, capped=False)
            else:
                with tracing.span('int8.sandwich'):
                    y = self._f32_node(node, xq, cur_sz, cache, layers, as_fp)
                    xq, cur_sz = edge(key, y)
            self._keep(i, xq, cur_sz, cache, inter, intermediates, as_fp)

        raws = [r for r, _ in heads]
        # no exp_cap, as the JAX package's int8 walk decodes
        with tracing.span('int8.decode'):
            preds = decode_all_heads(raws, [n for _, n in heads], plain, capped=False,
                                     dec=dec_fn)
        if intermediates:
            for (_, node), view in zip(heads, head_views(preds, [r.shape for r in raws])):
                inter[str(node.index)] = view
            return preds, inter
        return preds

    @staticmethod
    def _f32_node(node, xq, cur_sz, cache, layers, as_fp):
        """The f32 output of a node that runs between a dequant and a
        requant: shortcut, scale, route, pool or fc."""
        kind, a = node.kind, node.attrs
        if kind == 'shortcut':
            y = as_fp(xq, cur_sz) + as_fp(*cache[node.refs[0]])
            return L.apply_activation(a['activation'], y)
        if kind == 'scale_channels':
            return as_fp(*cache[node.refs[0]]) * as_fp(xq, cur_sz)
        if kind == 'route':
            srcs = [as_fp(*cache[r]) for r in node.refs]
            return srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=-1)
        if kind == 'maxpool':
            padding = solve_padding(a['size'], a['padding'], a['pad'])
            return L.max_pool(as_fp(xq, cur_sz), a['size'], a['stride'], padding)
        if kind == 'avgpool':
            return L.adaptive_avg_pool(as_fp(xq, cur_sz), *node.out_size)
        if kind == 'fc':
            y = L.linear(as_fp(xq, cur_sz).reshape(xq.shape[0], -1), layers[str(node.index)])
            return L.apply_activation(a['activation'], y)
        raise ValueError(kind)

    def _keep(self, i, val, sz, cache, inter, intermediates, as_fp):
        """Record node ``i``'s output, cache it for its later consumers and
        drop the cached outputs whose consumers have all run."""
        if intermediates:
            inter[str(i)] = as_fp(val, sz)
        last_use = self.graph.last_use
        if i in last_use:
            cache[i] = (val, sz)
        for j in [j for j in cache if last_use.get(j, -1) <= i and j != i]:
            del cache[j]
