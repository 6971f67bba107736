"""Int8 quantized inference (the port of ``pqdet_tpu/compress/quantized.py``).

BN-folded conv weights are quantised to per-output-channel symmetric int8
and activations to per-tensor affine uint8 with the QAT observers' ranges;
every quantised edge is requantised. Add, concat and scale run in f32
between a dequant and a requant, as in the JAX package.

``Int8Inference`` walks the quant graph in one of three modes:

- ``'kernel'`` (the JAX package's ``'pallas'``): activations in the
  recentred s8 form. One rule, ``conv_route``, gives each conv its
  kernel: a pointwise conv ``qconv1x1_s8`` (a strided one on the input's
  every stride-th pixel), a depthwise 3x3 ``qdwconv3x3_s8`` (both CUDA
  kernels on the card, ``csrc/qconv.cu``), a dense 3x3 whose Cin is a
  multiple of 16 ``qconv3x3_s8`` (an implicit GEMM: YOLOv3's 37 past its
  stem), a grouped 3x3 of Cout = Cin and group width 8, 16 or 24
  ``qgconv3x3_s8`` (each group's product from the input window: the
  RegNets' grouped 3x3s), and any other dense 3x3 and densified grouped
  3x3 im2col patches into ``qconv1x1_s8``. The input's
  quantisation, each shortcut and each route run as one ``int8_sandwich``
  launch from s8 to s8, and one Triton decode launch decodes the raw yolo
  heads into the preds. ``Int8Inference.routes`` is the walk's table of
  these choices. This is the serving path; ``apply(plain=True)`` takes
  the same routes through the plain versions (``ops.library.PLAIN``). It
  departs from the JAX package in two places, on the CPU and in the plain
  walk too: a strided 1x1 and a dense 3x3 wider than Cin 115 run exactly
  through those routes, where the JAX package runs its bf16 dequant conv;
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

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from pqdet_tpu_torch.bridge import from_jax_qparams, to_jax_qparams
from pqdet_tpu_torch.compress.qat import act_qparams, ieee_div
from pqdet_tpu_torch.model import layers as L
from pqdet_tpu_torch.model.graph import solve_padding
from pqdet_tpu_torch.model.network import (DetectionNetwork, decode_all_heads,
                                           decode_consumed_head, fuse_params)
from pqdet_tpu_torch.ops import library
from pqdet_tpu_torch.ops.decode_kernel import head_views
from pqdet_tpu_torch.ops.qconv import (C3_CIN_STEP, G3_GROUP_WIDTHS, SANDWICH_ACTS,
                                       SANDWICH_MAX_SOURCES, dequant_s8, make_scalars, quant_s8,
                                       sandwich_scalars)
from pqdet_tpu_torch.utils import tracing
from pqdet_tpu_torch.utils.codec import load_checkpoint, save_pytrees

# group widths (input channels per group) that ``prepare(network=)``
# densifies, the JAX package's range
DENSE_GROUP_WIDTHS = (2, 115)


def im2col_depth(cin: int) -> int:
    """K of the stem's im2col patches: 9 * Cin rounded up to 16 with zero
    columns (27 -> 32 for RGB), so each patch row is whole 16-byte copies
    for the 1x1 kernel. The zero columns meet zero weight rows: the
    integer sum and colsum are unchanged."""
    return -(-9 * cin // 16) * 16


def conv_route(attrs: Dict, cin: int) -> Optional[str]:
    """The kernel-mode route of a conv of cfg ``attrs`` (size, stride,
    padding, groups, filters) on ``cin`` input channels: ``'pw'`` a 1x1
    (padding 0, any stride), ``'dw'`` a depthwise 3x3, ``'c3'`` a dense 3x3
    (groups 1) whose Cin is a multiple of C3_CIN_STEP, ``'g3'`` a grouped
    3x3 whose Cout is its Cin and whose group width is one of
    G3_GROUP_WIDTHS, ``'im2col'`` any other dense 3x3 and a densified
    grouped 3x3 (patches into the 1x1 kernel); None a grouped conv not
    densified, another size or padding, a 3x3 at a stride past 2. A grouped
    conv is densified where its group width lies in DENSE_GROUP_WIDTHS and
    its Cout is a multiple of its groups. A patch row's s32 sum stays exact
    up to K = 132,104 (|sum| <= K * 128 * 127 < 2^31), far past any im2col
    depth a Cin of DENSE_GROUP_WIDTHS' range gives."""
    size, groups, filters = attrs['size'], attrs['groups'], attrs['filters']
    padding = solve_padding(size, attrs['padding'], attrs['pad'])
    dense = groups == 1 or (DENSE_GROUP_WIDTHS[0] <= cin // groups <= DENSE_GROUP_WIDTHS[1]
                            and filters % groups == 0)
    if size == 1:
        return 'pw' if padding == 0 and dense else None
    if size != 3 or padding != 1 or attrs['stride'] not in (1, 2):
        return None
    if groups == cin == filters:
        return 'dw'
    if groups == 1 and cin % C3_CIN_STEP == 0:
        return 'c3'
    if groups > 1 and filters == cin and cin % groups == 0 and cin // groups in G3_GROUP_WIDTHS:
        return 'g3'
    return 'im2col' if dense else None


def _fits(route: str, p: Dict, shape, stride: int) -> bool:
    """Whether ``route``'s view in the staged ``p`` takes an NHWC input of
    ``shape``: its input channels (a grouped 3x3's Cout, which is its Cin);
    even H and W for a 3x3 at stride 2."""
    _, h, w, c = shape
    view, axis, k = {'pw': ('w2d', 0, c), 'dw': ('wdw', 2, c), 'c3': ('w3', 1, 9 * c),
                     'g3': ('wg', 0, c), 'im2col': ('wim', 0, im2col_depth(c))}[route]
    return view in p and p[view].shape[axis] == k and (
        route == 'pw' or (h % stride == 0 and w % stride == 0))


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
        self._routes: Dict[tuple, Dict[str, Optional[str]]] = {}

    @staticmethod
    def prepare(qparams: Dict, mode: str = 'kernel', network: DetectionNetwork = None) -> Dict:
        """Derive the weight views of each conv's route (``conv_route``) in
        ``'kernel'`` mode, contiguous on the weights' device:
        - ``'pw'``: ``w2d`` (Cin, Cout) int8 and ``colsum`` (Cout,) int32;
        - ``'dw'``: ``wdw`` (3, 3, C);
        - ``'c3'``: ``w3`` (Cout, 9*Cin) in (kh, kw, cin) order and
          ``colsum``;
        - ``'g3'``: ``wg`` (Cout, 9*gw) of the compact grouped weights in
          (kh, kw, cin-in-group) order and ``colsum``;
        - ``'im2col'``: ``wim`` (im2col_depth(Cin), Cout) in (kh, kw, cin)
          order with zero rows after the 9*Cin taps, and ``wim_colsum``.
        With ``network`` given, a grouped conv that its route densifies
        (a grouped 1x1, or a grouped 3x3 that ``qgconv3x3_s8`` does not
        take) first becomes block-diagonal int8 weights
        (``layers.densify_grouped_weight``), as the JAX package's
        ``prepare(network=)`` does.
        Without it each conv takes the route of its weights' own shape
        (groups 1, but a depthwise 3x3 of one input channel a group), so a
        grouped conv's views are of its compact weights, which the walk
        admits for no input: such a conv runs the bf16 dequant conv on the
        CPU, as in JAX, and kernel mode raises on the card. ``wq`` stays
        grouped. Other modes stage the qparams as they are."""
        nodes = {} if network is None else {str(n.index): n for n in network.graph.nodes}
        layers = {}
        for key, p in qparams['layers'].items():
            p = dict(p)
            wq = p.get('wq') if mode == 'kernel' else None
            if wq is not None:
                cout, cin_g, k, _ = wq.shape
                node = nodes.get(key)
                g = node.attrs['groups'] if node else cout if (cin_g, k) == (1, 3) else 1
                route = conv_route(node.attrs if node else dict(
                    size=k, stride=1, padding=k // 2, pad=0, groups=g, filters=cout), cin_g * g)
                if route in ('pw', 'im2col') and g > 1:
                    wq = L.densify_grouped_weight(wq, g)
                cout, cin = wq.shape[:2]
                if route == 'pw':
                    p['w2d'] = wq.reshape(cout, cin).t()
                    p['colsum'] = p['w2d'].to(torch.int32).sum(0).to(torch.int32)
                elif route == 'dw':
                    p['wdw'] = wq.reshape(cout, 9).t().reshape(3, 3, cout)
                elif route in ('c3', 'g3'):
                    view = 'w3' if route == 'c3' else 'wg'
                    p[view] = wq.permute(0, 2, 3, 1).reshape(cout, 9 * cin)
                    p['colsum'] = p[view].to(torch.int32).sum(1).to(torch.int32)
                elif route == 'im2col':
                    wim = wq.permute(2, 3, 1, 0).reshape(9 * cin, cout)
                    p['wim'] = F.pad(wim, (0, 0, 0, im2col_depth(cin) - 9 * cin))
                    p['wim_colsum'] = p['wim'].to(torch.int32).sum(0).to(torch.int32)
            layers[key] = {k: v.contiguous() if isinstance(v, torch.Tensor) else v
                           for k, v in p.items()}
        return {'layers': layers, 'act': qparams['act']}

    def routes(self, act) -> Dict[str, Optional[str]]:
        """The walk's route table for the quantised edges ``act`` (its
        keys), on which ``apply`` dispatches, made once: in kernel mode each
        conv's ``conv_route`` where its input edge is quantised, and
        ``'sandwich'`` for the input and each shortcut (of an activation in
        SANDWICH_ACTS) or route (of at most SANDWICH_MAX_SOURCES sources)
        whose edges in and out are all quantised; None for every other
        conv and node between a dequant and a requant (the PyTorch chain)."""
        table = self._routes.get(tuple(act))
        if table is not None:
            return table
        kernel = self.mode == 'kernel'
        quantised = {-1: 'input' in act}           # each node's output edge
        table = {'input': 'sandwich' if kernel else None}
        for n in self.graph.nodes:
            i, key, kind, a = n.index, str(n.index), n.kind, n.attrs
            if kind in ('dropout', 'upsample'):
                quantised[i] = quantised[i - 1]
                continue
            quantised[i] = kind != 'yolo' and key in act
            if kind == 'convolutional':
                table[key] = conv_route(a, n.in_channels) if kernel and quantised[i - 1] else None
            elif kind != 'yolo':
                srcs = ((i - 1, n.refs[0]) if kind == 'shortcut'
                        and a['activation'] in SANDWICH_ACTS else n.refs
                        if kind == 'route' and len(n.refs) <= SANDWICH_MAX_SOURCES else None)
                fused = kernel and srcs is not None and all(quantised[j] for j in (i, *srcs))
                table[key] = 'sandwich' if fused else None
        self._routes[tuple(act)] = table
        return table

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
        view of the preds. Each node takes its entry of ``routes``, a conv
        where its input fits the staged view (``_fits``). ``kernels`` (an
        ``ops.library.Kernels`` table) says how the kernels run, never
        which: ``library.WRAPPERS`` by default, ``library.PLAIN`` (on any
        device) with ``plain``; an exported program walks with
        ``library.OPS``, the registered operators."""
        act = qparams['act']
        layers = qparams['layers']
        routes = self.routes(act)
        cache: Dict[int, tuple] = {}
        inter: Dict[str, torch.Tensor] = {}
        heads = []                       # (raw f32 head, yolo node)
        kernel = self.mode == 'kernel'
        if kernels is None:
            kernels = library.PLAIN if plain else library.WRAPPERS
        pw_fn, dw_fn, dec_fn, sw_fn, c3_fn, g3_fn = kernels

        def as_fp(val, sz):
            if sz is None:
                return val
            return dequant_s8(val, sz[0], sz[1] - 128.0) if kernel else _dequant(val, sz)

        def requant(y, sz):
            if self.mode == 'dequant':
                return _fake_quant_edge(y, sz), None
            return (quant_s8(y, sz[0], sz[1] - 128.0), sz) if kernel else (_quant(y, sz), sz)

        def edge(key, y):
            if key in act:  # requantise this edge
                return requant(y, act[key])
            return y, None  # f32 edge (feeds a yolo head)

        def sandwich(key, vals, edges, form, act_name='linear'):
            """Node ``key`` (or 'input') as one ``int8_sandwich`` of ``vals``
            on ``edges``."""
            sc = self._sandwich_vector(key, edges, act[key], vals[0].device)
            return sw_fn(vals, sc, form=form, act=act_name), act[key]

        # spans (utils/tracing.py): int8.sandwich around a quantisation or a
        # node's sandwich or chain; int8.im2col, int8.kernel and int8.decode
        # around the patches, the int8 kernels and the decode; int8.conv3x3
        # around a 3x3's patches (int8.im2col_bytes) and GEMM or its launch
        with tracing.span('int8.sandwich'):
            if routes['input'] == 'sandwich' and x.dtype == torch.float32:
                xq, cur_sz = sandwich('input', [x.contiguous()], (), 'input')
            else:
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
                route = routes[key]
                if route is not None and _fits(route, p, xq.shape, stride):
                    out_edge = act.get(key)
                    common = dict(act=a['activation'], requant=out_edge is not None,
                                  scalars=self._scalar_vector(key, cur_sz, out_edge,
                                                              xq.device))
                    if route == 'pw':
                        # a strided 1x1 (the RegNets' projections) is the 1x1
                        # of the input's every stride-th row and column
                        xs = xq
                        if stride != 1:
                            with tracing.span('int8.im2col'):
                                xs = xq[:, ::stride, ::stride].contiguous()
                        with tracing.span('int8.kernel'):
                            y = pw_fn(xs, p['w2d'], p['w_scale'], p['b'], p['colsum'],
                                      **common)
                    elif route == 'dw':
                        with tracing.span('int8.kernel'):
                            y = dw_fn(xq, p['wdw'], p['w_scale'], p['b'], stride=stride,
                                      **common)
                    elif route in ('c3', 'g3'):
                        fn, view = (c3_fn, 'w3') if route == 'c3' else (g3_fn, 'wg')
                        with tracing.span('int8.conv3x3'):
                            with tracing.span('int8.kernel'):
                                y = fn(xq, p[view], p['w_scale'], p['b'], p['colsum'],
                                       stride=stride, **common)
                    else:
                        with tracing.span('int8.conv3x3'):
                            with tracing.span('int8.im2col'):
                                patches = _stem_im2col(xq, stride, round(cur_sz[1]) - 128)
                            tracing.count('int8.im2col_bytes', patches.numel())
                            with tracing.span('int8.kernel'):
                                y = pw_fn(patches, p['wim'], p['w_scale'], p['b'],
                                          p['wim_colsum'], **common)
                    xq, cur_sz = y, out_edge
                    self._keep(i, xq, cur_sz, cache, inter, intermediates, as_fp)
                    continue
                if kernel and not plain and xq.device.type != 'cpu':
                    # off the CPU the kernel path runs its kernels or raises;
                    # on the CPU and in the plain walk a conv that takes no
                    # route (a compact grouped conv, a stride-2 3x3 on odd
                    # H or W, a kernel size other than 1 and 3) runs the JAX
                    # package's bf16 dequant conv
                    raise ValueError(
                        f'Int8Inference kernel mode: conv {key} (size {a["size"]}, '
                        f'stride {stride}, groups {a["groups"]}, input {tuple(xq.shape)}, '
                        f'quantised input {cur_sz is not None}, route {route}) fits neither '
                        'int8 kernel')
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
                    if routes[key] == 'sandwich':
                        srcs = [(xq, cur_sz), cache[node.refs[0]]] if kind == 'shortcut' \
                            else [cache[r] for r in node.refs]
                        xq, cur_sz = sandwich(key, [v for v, _ in srcs], tuple(e for _, e in srcs),
                                              kind, a['activation'] if kind == 'shortcut'
                                              else 'linear')
                    else:
                        xq, cur_sz = edge(key, self._f32_node(node, xq, cur_sz, cache,
                                                              layers, as_fp))
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

    def _sandwich_vector(self, key, src_edges, out_edge, device):
        """The sandwich's scalar vector of node ``key`` (or 'input'), made once
        per edge qparams and device, in the cache of ``_scalar_vector``."""
        k = (key, src_edges, out_edge, str(device))
        sc = self._scalars.get(k)
        if sc is None:
            sc = self._scalars[k] = sandwich_scalars(src_edges, out_edge, device)
        return sc

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
