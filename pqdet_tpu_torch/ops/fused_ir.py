"""Fused bf16 inverted-residual block: the CUDA kernel's wrapper, its plain
version, and the walk-time fusion table.

The port of ``pqdet_tpu/ops/pallas_fused.py``. The kernel
(``csrc/fused_ir.cu``) computes

    [1x1 expand + act_e] -> [dw 3x3 s1 p1 + act_dw] -> [1x1 project + act_p]

on NHWC bf16 in one launch, keeping the expanded activation out of device
memory; a bare dw3x3 + pw1x1 pair when there is no expand. Weights are in
the kernel's layout, unpadded: we (Cin, E) bf16, be (E,) f32, wdw (9, E)
bf16, bdw (E,) f32, wp (E, P) bf16, bp (P,) f32; the kernel masks ragged
E and P itself (the JAX package padded them to 128 lanes, a TPU layout
artifact).

``fused_ir_conv`` runs the kernel for a CUDA tensor and the plain
``fused_ir_reference`` for a CPU tensor; it raises on any other device.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pqdet_tpu_torch.model.graph import solve_padding

LANE = 128  # bare-pair rule of find_fused_triples: dw width a whole lane tile

ACT_CODES = {'linear': 0, 'none': 0, 'relu': 1, 'relu6': 2, 'leaky': 3,
             'logistic': 4}
_FUSABLE_ACTS = ('relu6', 'relu', 'leaky', 'linear', 'none', 'logistic')


def _apply_act(act: str, y):
    if act == 'leaky':
        return torch.where(y > 0, y, 0.1 * y)
    if act == 'relu':
        return torch.clamp_min(y, 0.0)
    if act == 'relu6':
        return torch.clamp(y, 0.0, 6.0)
    if act in ('linear', 'none'):
        return y
    if act == 'logistic':
        return torch.sigmoid(y)
    raise ValueError(f'unsupported activation for the fused kernel: {act}')


def _bf(t):
    """Round to bf16 and compute on in f32."""
    return t.to(torch.bfloat16).float()


def fused_ir_reference(x, we, be, wdw, bdw, wp, bp, *, act_e='relu6',
                       act_dw='relu6', act_p='linear'):
    """Plain version of the kernel: f32 arithmetic on bf16-rounded inputs
    and weights, with an explicit bf16 round at the three stage
    boundaries (exactly the bf16 discipline, also on the CPU where bf16
    depthwise convs are a weak spot). Same arguments as the kernel;
    returns (N, H, W, P) bf16."""
    y = _bf(x)
    if we is not None:
        y = _bf(_apply_act(act_e, y @ _bf(we) + be.float()))
    e = wdw.shape[1]
    k = _bf(wdw).t().reshape(e, 1, 3, 3)
    y = F.conv2d(y.permute(0, 3, 1, 2), k, None, 1, 1, 1, e).permute(0, 2, 3, 1)
    y = _bf(_apply_act(act_dw, y + bdw.float()))
    y = _apply_act(act_p, y @ _bf(wp) + bp.float())
    return y.to(torch.bfloat16)


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f'fused_ir_conv: {name} must be a contiguous {dtype} '
                         f'tensor of shape {tuple(shape)} on {device}, got '
                         f'{t.dtype} {tuple(t.shape)} on {t.device} '
                         f'(contiguous={t.is_contiguous()})')


def launch_fused_ir(lib, x, we, be, wdw, bdw, wp, bp, out, act_e, act_dw,
                    act_p, stream: int) -> int:
    """One call of the C entry point ``fused_ir_launch`` of ``lib`` on
    checked tensors; returns its CUDA error code."""
    fn = lib.fused_ir_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    n, h, w, cin = x.shape
    e, p = wdw.shape[1], wp.shape[1]
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    return fn(ptr(x), ptr(we), ptr(be), ptr(wdw), ptr(bdw), ptr(wp), ptr(bp),
              ptr(out), n, h, w, cin, e, p, int(we is not None),
              ACT_CODES[act_e], ACT_CODES[act_dw], ACT_CODES[act_p], stream)


def fused_ir_conv(x, we, be, wdw, bdw, wp, bp, *, act_e: str = 'relu6',
                  act_dw: str = 'relu6', act_p: str = 'linear'):
    """Fused [expand + act] -> [dw3x3 + act] -> [project + act] on NHWC
    bf16 ``x`` (N, H, W, Cin); ``we``/``be`` None for a bare pair
    (Cin == E). Returns (N, H, W, P) bf16. Launches the CUDA kernel for a
    CUDA tensor, runs ``fused_ir_reference`` for a CPU tensor."""
    if x.device.type == 'cpu':
        return fused_ir_reference(x, we, be, wdw, bdw, wp, bp, act_e=act_e,
                                  act_dw=act_dw, act_p=act_p)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_ir_conv: no kernel for device {x.device}')
    for a in (act_e, act_dw, act_p):
        if a not in ACT_CODES:
            raise ValueError(f'fused_ir_conv: unsupported activation {a!r}')
    n, h, w, cin = x.shape
    e, p = wdw.shape[1], wp.shape[1]
    dev = x.device
    _check('x', x, torch.bfloat16, (n, h, w, cin), dev)
    if we is None:
        if cin != e:
            raise ValueError(f'fused_ir_conv: a bare pair needs Cin == E, got {cin} != {e}')
    else:
        _check('we', we, torch.bfloat16, (cin, e), dev)
        _check('be', be, torch.float32, (e,), dev)
    _check('wdw', wdw, torch.bfloat16, (9, e), dev)
    _check('bdw', bdw, torch.float32, (e,), dev)
    _check('wp', wp, torch.bfloat16, (e, p), dev)
    _check('bp', bp, torch.float32, (p,), dev)
    out = torch.empty((n, h, w, p), dtype=torch.bfloat16, device=dev)
    if out.numel() == 0:
        return out
    from pqdet_tpu_torch.ops._build import load_library
    rc = launch_fused_ir(load_library('fused_ir'), x, we, be, wdw, bdw, wp, bp,
                         out, act_e, act_dw, act_p,
                         torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'fused_ir_conv: kernel launch failed with CUDA error {rc}')
    fused_ir_conv.launches += 1
    return out


fused_ir_conv.launches = 0


def pad_fused_weights(we, be, wdw, bdw, wp, bp):
    """BN-fused OIHW weights -> the kernel's layout: we (Cin, E), wdw
    (9, E), wp (E, P). Unlike the JAX package, which zero-pads E and P to
    128 lanes, nothing is padded: the CUDA kernel masks ragged tiles.

    Inputs: we (E, Cin, 1, 1) or None, wdw (E, 1, 3, 3), wp (P, E, 1, 1).
    Returns (we, be, wdw9, bdw, wp, bp, cout)."""
    e = wdw.shape[0]
    cout = wp.shape[0]
    we2 = None if we is None else we.reshape(e, -1).t()
    be = None if be is None else be.reshape(-1)
    return (we2, be, wdw.reshape(e, 9).t(), bdw.reshape(-1),
            wp.reshape(cout, e).t(), bp.reshape(-1), cout)


def find_fused_triples(graph):
    """Scan a Graph for [1x1 conv] -> [dw3x3 s1 p1] -> [1x1 conv] chains
    whose inner activations feed ONLY the next node (not in last_use).
    Returns [(a, b, c)] node-index triples; also (None, b, c) bare dw+pw
    pairs when the dw's predecessor is not a fusable 1x1 but the dw
    channel count is a whole number of 128-channel tiles (the JAX
    package's selection rule, kept so both fuse the same chains)."""
    out = []
    nodes = graph.nodes
    last_use = graph.last_use

    def conv(n):
        return n.kind == 'convolutional'

    def is_pw(n):
        a = n.attrs
        return conv(n) and a['size'] == 1 and a['stride'] == 1 \
            and a['groups'] == 1 and a['activation'] in _FUSABLE_ACTS \
            and solve_padding(a['size'], a['padding'], a['pad']) == 0

    def is_dw_s1(n):
        # the kernel hard-codes SAME padding (pad=1)
        a = n.attrs
        return conv(n) and a['size'] == 3 and a['stride'] == 1 \
            and a['groups'] == n.in_channels \
            and n.in_channels == n.out_channels \
            and a['activation'] in _FUSABLE_ACTS \
            and solve_padding(a['size'], a['padding'], a['pad']) == 1

    used = set()
    for i in range(len(nodes) - 2):
        a, b, c = nodes[i], nodes[i + 1], nodes[i + 2]
        if i in used or not (is_pw(a) and is_dw_s1(b) and is_pw(c)):
            continue
        if last_use.get(a.index, -1) > b.index \
                or last_use.get(b.index, -1) > c.index:
            continue
        out.append((a.index, b.index, c.index))
        used.update((i, i + 1, i + 2))
    for i in range(len(nodes) - 1):
        b, c = nodes[i], nodes[i + 1]
        if i in used or i + 1 in used or not (is_dw_s1(b) and is_pw(c)):
            continue
        if last_use.get(b.index, -1) > c.index or b.in_channels % LANE:
            continue
        out.append((None, b.index, c.index))
        used.update((i, i + 1))
    return out


def prepare_fused_ir(network, fused_params):
    """Build the walk-time fusion table from BN-fused inference params:
    {start_node_index: {kernel weights + activations + skip set + end}}.
    Weights are cast once here: bf16 matrices, f32 biases."""
    table = {}
    nodes = {n.index: n for n in network.graph.nodes}
    for a, b, c in find_fused_triples(network.graph):
        pb, pc = fused_params[str(b)], fused_params[str(c)]
        if 'bn' in pb or 'bn' in pc or 'b' not in pb or 'b' not in pc:
            continue  # only BN-fused inference params
        if a is not None:
            pa = fused_params[str(a)]
            if 'bn' in pa or 'b' not in pa:
                continue
            we, be = pa['w'], pa['b']
            act_e = nodes[a].attrs['activation']
        else:
            we = be = None
            act_e = 'linear'
        we, be, wdw, bdw, wp, bp, cout = pad_fused_weights(
            we, be, pb['w'], pb['b'], pc['w'], pc['b'])
        bf16 = lambda t: t.to(torch.bfloat16).contiguous()  # noqa: E731
        f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
        start = a if a is not None else b
        table[start] = dict(
            we=None if we is None else bf16(we), be=None if be is None else f32(be),
            wdw=bf16(wdw), bdw=f32(bdw), wp=bf16(wp), bp=f32(bp), cout=cout,
            act_e=act_e, act_dw=nodes[b].attrs['activation'],
            act_p=nodes[c].attrs['activation'],
            skip=tuple(i for i in (a, b, c) if i is not None and i != start),
            end=c)
    return table
