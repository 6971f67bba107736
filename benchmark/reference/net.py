"""The plain float32 reference of the detectors: the cfg's layers, in order,
as ``torch.nn.functional`` calls on NCHW tensors.

Parameters come as the benchmark makes them (``benchmark/weights.py``):
``params[str(i)]`` holds a conv's OIHW ``w`` and either its bias ``b`` or
its BN's ``bn`` = {gamma, beta}; ``state[str(i)]`` the BN's running mean
and var. Inference folds BN into the conv here (``fold``), with the
variance's epsilon 1e-5; training runs BN on the batch's moments and mixes
the unbiased variance into the running statistics with momentum 0.1.

A yolo layer decodes the conv before it, A = channels / (5 + C) boxes a
cell: x1y1 = (cell centre - exp(t0:2)) * stride, x2y2 = (cell centre +
exp(t2:4)) * stride, objectness sigmoid(t4), classes sigmoid(t5:). The
heads are flattened (B, H * W * A, 5 + C) in the order of their layers.

``lowp`` names a lower precision that every conv's input and weights are
rounded to (the control of ``benchmark/control.py``): ``'fp8'`` is e4m3
with one scale per tensor for the input and one per output channel for the
weights (amax / 448), rounded through a straight-through estimator so that
autograd passes the gradient unchanged. In training the conv's output,
which BN normalizes in the program's compute dtype, is rounded too.
``'fp8_bwd'`` rounds the same and also the conv's backward: the gradient
that reaches a conv's output and the one it hands to its input are rounded
to e5m2, with one scale per tensor (amax / 57344), as FP8 training keeps
its gradients.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)     # ImageNet's, the inputs' normalization
STD = (0.229, 0.224, 0.225)
BN_EPS = 1e-5
BN_MOMENTUM = 0.1
FP8_MAX = 448.0
E5M2_MAX = 57344.0

ACTS = {
    'linear': lambda x: x,
    'relu': F.relu,
    'relu6': lambda x: torch.clamp(x, 0.0, 6.0),
    'leaky': lambda x: F.leaky_relu(x, 0.1),
    'logistic': torch.sigmoid,
}


def no_tf32():
    """Context that turns TF32 off for matmuls and cuDNN convs: the
    reference is float32."""
    class _Ctx:
        def __enter__(self):
            self.prev = (torch.backends.cuda.matmul.allow_tf32,
                         torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        def __exit__(self, *exc):
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.prev
    return _Ctx()


def normalize(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 NHWC -> (x / 255 - mean) / std, float32."""
    mean = torch.tensor(MEAN, device=images_u8.device)
    std = torch.tensor(STD, device=images_u8.device)
    return (images_u8.float() / 255.0 - mean) / std


def round_fp8(t: torch.Tensor, dims) -> torch.Tensor:
    """``t`` rounded to e4m3 with a scale of amax / 448 over ``dims``
    (straight-through under autograd)."""
    amax = t.detach().abs().amax(dim=dims, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach()


class _RoundGrad(torch.autograd.Function):
    """The identity, whose backward rounds the gradient to e5m2."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        scale = g.abs().amax().clamp_min(1e-30) / E5M2_MAX
        return (g / scale).to(torch.float8_e5m2).float() * scale


def round_grad_e5m2(t: torch.Tensor) -> torch.Tensor:
    return _RoundGrad.apply(t)


def fold(p: Dict, s: Optional[Dict]):
    """(w, b) of a conv with its BN folded in."""
    w = p['w'].float()
    if 'bn' not in p:
        return w, p['b'].float()
    scale = p['bn']['gamma'].float() / torch.sqrt(s['var'].float() + BN_EPS)
    return w * scale[:, None, None, None], p['bn']['beta'].float() - s['mean'].float() * scale


def decode(raw: torch.Tensor, classes: int, stride: int) -> torch.Tensor:
    """NCHW raw head -> (B, H * W * A, 5 + C)."""
    b, ch, h, w = raw.shape
    a = ch // (5 + classes)
    t = raw.permute(0, 2, 3, 1).reshape(b, h, w, a, 5 + classes).float()
    ys = torch.arange(h, dtype=torch.float32, device=raw.device) + 0.5
    xs = torch.arange(w, dtype=torch.float32, device=raw.device) + 0.5
    grid = torch.stack(torch.meshgrid(xs, ys, indexing='xy'), -1)[:, :, None, :]
    xymin = (grid - torch.exp(t[..., 0:2])) * stride
    xymax = (grid + torch.exp(t[..., 2:4])) * stride
    out = torch.cat([xymin, xymax, torch.sigmoid(t[..., 4:5]), torch.sigmoid(t[..., 5:])], -1)
    return out.reshape(b, h * w * a, 5 + classes)


def walk(lays: List[Dict], x: torch.Tensor, conv, on_head=None) -> List[torch.Tensor]:
    """Run the layers on NCHW ``x``: ``conv(layer, x)`` computes a conv
    layer, activation included. Returns the raw heads, each also handed to
    ``on_head(layer, raw)`` if given."""
    keep = {r for l in lays for r in l.get('refs', ())}
    outs: Dict[int, torch.Tensor] = {}
    heads = []
    for l in lays:
        k = l['kind']
        if k == 'convolutional':
            x = conv(l, x)
        elif k == 'shortcut':
            x = ACTS[l['act']](x + outs[l['refs'][0]])
        elif k == 'route':
            x = torch.cat([outs[r] for r in l['refs']], 1)
        elif k == 'upsample':
            x = F.interpolate(x, scale_factor=l['stride'], mode='nearest')
        elif k == 'yolo':
            heads.append(x)
            if on_head is not None:
                on_head(l, x)
        if l['index'] in keep:
            outs[l['index']] = x
    return heads


def heads_of(lays):
    return [l for l in lays if l['kind'] == 'yolo']


def infer(lays: List[Dict], params: Dict, state: Dict, x_nhwc: torch.Tensor,
          lowp: Optional[str] = None) -> torch.Tensor:
    """Inference of normalized NHWC ``x_nhwc``: (B, sum HWA, 5 + C) preds."""
    folded = {}

    def conv(l, x):
        key = str(l['index'])
        if key not in folded:
            folded[key] = fold(params[key], state.get(key))
        w, b = folded[key]
        if lowp == 'fp8':
            x, w = round_fp8(x, (0, 1, 2, 3)), round_fp8(w, (1, 2, 3))
        y = F.conv2d(x, w, b, l['stride'], l['pad'], 1, l['groups'])
        return ACTS[l['act']](y)

    with torch.no_grad():
        raws = walk(lays, x_nhwc.permute(0, 3, 1, 2).float(), conv)
        return torch.cat([decode(r, h['classes'], h['stride_total'])
                          for r, h in zip(raws, heads_of(lays))], 1)


def train_forward(lays: List[Dict], params: Dict, state: Dict, x_nhwc: torch.Tensor,
                  lowp: Optional[str] = None):
    """The training forward: BN on the batch's moments. Returns (the decoded
    heads, each (B, H, W, A, 5 + C), and the new BN running statistics)."""
    new_state = {}

    def conv(l, x):
        key = str(l['index'])
        p = params[key]
        w = p['w']
        if lowp in ('fp8', 'fp8_bwd'):
            x, w = round_fp8(x, (0, 1, 2, 3)), round_fp8(w, (1, 2, 3))
        if lowp == 'fp8_bwd':
            x = round_grad_e5m2(x)
        y = F.conv2d(x, w, p.get('b'), l['stride'], l['pad'], 1, l['groups'])
        if lowp in ('fp8', 'fp8_bwd'):
            y = round_fp8(y, (0, 1, 2, 3))
        if lowp == 'fp8_bwd':
            y = round_grad_e5m2(y)
        if 'bn' in p:
            rm, rv = state[key]['mean'].clone(), state[key]['var'].clone()
            y = F.batch_norm(y, rm, rv, p['bn']['gamma'], p['bn']['beta'], True,
                             BN_MOMENTUM, BN_EPS)
            new_state[key] = {'mean': rm, 'var': rv}
        return ACTS[l['act']](y)

    raws = walk(lays, x_nhwc.permute(0, 3, 1, 2).float(), conv)
    heads = []
    for r, h in zip(raws, heads_of(lays)):
        b, _, hh, ww = r.shape
        heads.append(decode(r, h['classes'], h['stride_total']).reshape(b, hh, ww, -1,
                                                                          5 + h['classes']))
    return heads, new_state
