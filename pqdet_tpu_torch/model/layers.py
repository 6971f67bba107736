"""Functional PyTorch layers for the graph walk.

The port of ``pqdet_tpu/model/layers.py``. Public functions keep the JAX
package's NHWC layout, so the tests compare like with like; inside, a
tensor is handed to ``torch.nn.functional`` as an NCHW view with
``channels_last`` strides (``x.permute(0, 3, 1, 2)`` of an NHWC-contiguous
tensor), which costs no copy. Conv weights are OIHW, PyTorch's layout
(the JAX package keeps HWIO; ``bridge.py`` converts).

Initialisation matches torch defaults (kaiming-uniform fan_in for conv and
linear weights, uniform bound 1/sqrt(fan_in) for biases), drawn from an
explicit ``torch.Generator``. Train-mode batch norm returns its new running
statistics (it never writes them in place); dropout draws from an explicit
generator.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from pqdet_tpu_torch.parallel.halo import band_rows, fill_rows, halo_pad

BN_EPS = 1e-5       # torch nn.BatchNorm2d default
BN_MOMENTUM = 0.1   # torch nn.BatchNorm2d default


# ----------------------------------------------------------------- activations

def mish(x):
    return x * torch.tanh(F.softplus(x))


# Under autograd the kinks take the JAX package's subgradients (jnp.clip is
# a maximum and a minimum, which split a tie 0.5 / 0.5; its leaky relu is a
# where on x >= 0); torch.clamp and F.leaky_relu, one kernel each, give the
# same values where no gradient is taken.
def relu6(x):
    if x.requires_grad:
        return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_full((), 6.0))
    return torch.clamp(x, 0.0, 6.0)


def leaky(x):
    if x.requires_grad:
        return torch.where(x >= 0, x, 0.1 * x)
    return F.leaky_relu(x, 0.1)


ACTIVATION_FNS = {
    'logistic': torch.sigmoid,
    'leaky': leaky,
    'relu': torch.relu,
    'relu6': relu6,
    'tanh': torch.tanh,
    'mish': mish,
    'linear': lambda x: x,
}


def apply_activation(name: str, x):
    return ACTIVATION_FNS[name](x)


# ------------------------------------------------------------- initialisation

def _uniform(gen: torch.Generator, shape, bound: float) -> torch.Tensor:
    return (torch.rand(shape, generator=gen, dtype=torch.float32) * 2.0 - 1.0) * bound


def init_conv(gen: torch.Generator, in_channels: int, out_channels: int,
              size: int, groups: int = 1, bias: bool = True) -> dict:
    """Conv kernel in OIHW layout: (out, in/groups, size, size)."""
    fan_in = (in_channels // groups) * size * size
    # torch kaiming_uniform_ with a=sqrt(5): gain = sqrt(1/3)
    bound = math.sqrt(1.0 / 3.0) * math.sqrt(3.0 / fan_in)
    params = {'w': _uniform(gen, (out_channels, in_channels // groups, size, size), bound)}
    if bias:
        params['b'] = _uniform(gen, (out_channels,), 1.0 / math.sqrt(fan_in))
    return params


def init_bn(num_features: int) -> Tuple[dict, dict]:
    params = {'gamma': torch.ones(num_features), 'beta': torch.zeros(num_features)}
    state = {'mean': torch.zeros(num_features), 'var': torch.ones(num_features)}
    return params, state


def init_linear(gen: torch.Generator, in_features: int, out_features: int) -> dict:
    """Linear weights in torch layout (out, in)."""
    bound = math.sqrt(1.0 / 3.0) * math.sqrt(3.0 / in_features)
    return {'w': _uniform(gen, (out_features, in_features), bound),
            'b': _uniform(gen, (out_features,), 1.0 / math.sqrt(in_features))}


# ------------------------------------------------------------------ forwards

def _nchw(x):
    """NHWC tensor -> NCHW view (channels_last strides, no copy)."""
    return x.permute(0, 3, 1, 2)


def _nhwc(x):
    return x.permute(0, 2, 3, 1)


def densify_grouped_weight(w: torch.Tensor, groups: int) -> torch.Tensor:
    """Compact grouped OIHW weights (cout, cin/g, kh, kw) -> block-diagonal
    dense (cout, cin, kh, kw), as a differentiable op (the port of the JAX
    package's ``densify_grouped_weight``, which works on HWIO).

    The blocks are written into zeros (+0.0 off the blocks, the bytes of
    the JAX package's ``densify_grouped_convs``), so under autograd the
    weight gradient is gathered back from the blocks exactly: a dense conv
    on these weights computes the grouped conv's function and gradient.
    Works for any dtype (the int8 weights of ``compress/quantized.py``)."""
    cout, cin_g, kh, kw = w.shape
    cpg = cout // groups
    g = torch.arange(groups, device=w.device)
    dense = w.new_zeros((groups, cpg, groups, cin_g, kh, kw))
    dense[g, :, g] = w.reshape(groups, cpg, cin_g, kh, kw)
    return dense.reshape(cout, groups * cin_g, kh, kw)


def conv2d(x, w, b=None, stride: int = 1, padding: int = 0, groups: int = 1,
           compute_dtype: Optional[torch.dtype] = None, spatial=None, what: str = 'conv'):
    """2-D convolution, NHWC x OIHW -> NHWC.

    A grouped conv whose weights are already block-diagonal DENSE (the JAX
    package's ``densify_grouped_convs`` inference form) runs as one dense
    conv. Without ``compute_dtype`` the conv runs in f32; with it, inputs
    and weights are cast and the output stays in that dtype (cuDNN
    accumulates in f32 internally), the bias added in the output dtype.

    With ``spatial`` (a ``parallel.mesh.SpatialCtx``) ``x`` is this rank's
    band of rows: the rows the window needs from the neighbouring bands
    come by halo exchange (``parallel/halo.py``, zeros at the image's
    edges), the conv runs with no row padding and returns this band's rows
    of the unsharded output; ``what`` names the layer in its errors.
    """
    if groups > 1 and w.shape[1] == x.shape[-1]:
        groups = 1
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    else:
        x = x.float()
        w = w.float()
    h_out = None
    if spatial is not None:
        top, bottom, h_out = band_rows(x.shape[1], w.shape[2], stride, padding,
                                       spatial.n_space, what)
        x = halo_pad(x, top, bottom, 0.0, spatial)
        padding = (0, padding)
    xc = _nchw(x)
    if not xc.is_contiguous(memory_format=torch.channels_last):
        xc = xc.contiguous(memory_format=torch.channels_last)
    out = _nhwc(F.conv2d(xc, w, None, stride, padding, 1, groups))
    if h_out is not None:
        out = out[:, :h_out]
    if b is not None:
        out = out + b.to(out.dtype)
    return out.contiguous()


def _bn_moments(x):
    """One-pass batch moments of NHWC ``x`` in f32: E[x] and the biased
    Var[x], as E[d^2] - E[d]^2 of d = x - s. The per-channel shift s, the
    mean of the strided subsample ``x[:, ::8, ::8]``, is detached; it keeps
    the subtraction free of cancellation, and mean and variance do not
    depend on it, so neither do their gradients."""
    n = x.numel() // x.shape[-1]
    dims = tuple(range(x.dim() - 1))
    s = x[:, ::8, ::8, :].float().mean(dim=dims).detach()
    d = x.float() - s
    dm = d.sum(dim=dims) / n
    var = torch.clamp_min(torch.square(d).sum(dim=dims) / n - torch.square(dm), 0.0)
    return s + dm, var


def _bn_moments_synced(x, group, spatial=None, rows=None):
    """``_bn_moments`` of the global batch whose local shard each rank of
    ``group`` holds (sync-BN, as JAX's sharded step computes it): the
    shift s is the mean of the global strided subsample (its sums
    all-reduced, detached); the sums of d and d^2 go through a
    differentiable all-reduce, so the backward pass all-reduces the BN
    backward sums, as the transpose of GSPMD's psum does. The shards are
    equal (``TrainData`` enforces it), so the global counts are the local
    ones times the world. With ``spatial`` each rank holds a band of rows
    of its data shard: the subsample takes the band's rows at global rows
    0 mod 8 (the band's offset), so the shift is the one-process shift.
    ``rows``: the activation's real global rows when the walk's input was
    padded (``parallel/halo.py``); the rows past it count nowhere.
    Returns (mean, biased var, global element count)."""
    from pqdet_tpu_torch.parallel.mesh import all_reduce_sum
    w = dist.get_world_size(group)
    dims = tuple(range(x.dim() - 1))
    n = w * (x.numel() // x.shape[-1])
    if spatial is None:
        sub = x[:, ::8, ::8, :].float()
        n_sub = w * (sub.numel() // x.shape[-1])
    else:
        b, h, wd = x.shape[:3]
        off = spatial.offset(h)
        real = h * spatial.n_space if rows is None else rows
        sub = x[:, (-off) % 8:max(real - off, 0):8, ::8, :].float()
        n_sub = b * spatial.n_data * -(-real // 8) * -(-wd // 8)
        if rows is not None:
            n = b * spatial.n_data * rows * wd
    s = sub.sum(dim=dims).detach()
    dist.all_reduce(s, group=group)
    s = s / n_sub
    d = x.float() - s
    if rows is not None:
        d = fill_rows(d, rows, 0.0, spatial)
    c = x.shape[-1]
    sums = all_reduce_sum(torch.cat([d.sum(dim=dims), torch.square(d).sum(dim=dims)]), group)
    dm = sums[:c] / n
    var = torch.clamp_min(sums[c:] / n - torch.square(dm), 0.0)
    return s + dm, var, n


def batch_norm(x, params, state, train: bool = False, group=None, spatial=None, rows=None):
    """BatchNorm over (N, H, W) of NHWC ``x``; returns (y, new state).

    Train mode normalises with the batch's moments (biased variance) and
    returns new running statistics, the unbiased variance mixed in with
    ``BN_MOMENTUM``, as torch.nn.BatchNorm2d; ``state`` is not written.
    With a process ``group`` (data parallelism, ``parallel/mesh.py``) the
    batch is the global one, whose shards the ranks hold: its moments and
    element count (``_bn_moments_synced``); with ``spatial`` as well, the
    shards are bands of rows of the data shards (``group`` is then the
    world), whose real global rows are ``rows`` when the walk's input was
    padded. Eval mode normalises with the running statistics, returns
    ``state`` and never communicates. ``y`` is in ``x.dtype``."""
    gamma, beta = params['gamma'], params['beta']
    if not train:
        mean, var = state['mean'], state['var']
    elif group is None:
        mean, var = _bn_moments(x)
        n = x.numel() // x.shape[-1]
    else:
        mean, var, n = _bn_moments_synced(x, group, spatial, rows)
    inv = torch.rsqrt(var + BN_EPS) * gamma
    y = (x - mean.to(x.dtype)) * inv.to(x.dtype) + beta.to(x.dtype)
    if not train:
        return y, state
    unbiased = (var * (n / max(n - 1, 1))).detach()
    return y, {'mean': (1 - BN_MOMENTUM) * state['mean'] + BN_MOMENTUM * mean.detach(),
               'var': (1 - BN_MOMENTUM) * state['var'] + BN_MOMENTUM * unbiased}


def fold_bn_into_conv(conv_params: dict, bn_params: dict, bn_state: dict) -> dict:
    """Fold inference-mode BN into the OIHW conv weights and bias. The root
    is taken in f64 and rounded to the variance's dtype: the correctly
    rounded root, which the card's and JAX's f32 sqrt give and torch's f32
    sqrt on the CPU (MKL's) misses by an ulp in about 0.7 % of elements."""
    w = conv_params['w']
    var = bn_state['var'] + BN_EPS
    scale = bn_params['gamma'] / torch.sqrt(var.double()).to(var.dtype)
    new_w = w * scale[:, None, None, None]
    b = conv_params.get('b')
    if b is None:
        b = torch.zeros(w.shape[0], dtype=w.dtype, device=w.device)
    new_b = (b - bn_state['mean']) * scale + bn_params['beta']
    return {'w': new_w, 'b': new_b}


def max_pool(x, size: int, stride: int, padding: int, spatial=None, what: str = 'maxpool',
             rows=None):
    """NHWC max pool. Padding uses -inf so padded cells never win (any
    padding width, unlike ``F.max_pool2d``'s own limit of size/2). With
    ``spatial`` ``x`` is a band of rows, as for ``conv2d``: the halo rows
    come from the neighbouring bands (-inf at the image's edges, and at
    the global rows from ``rows`` on, the padding past the real height)."""
    h_out, pad_h = None, padding
    if spatial is not None:
        x = fill_rows(x, rows, float('-inf'), spatial)
        top, bottom, h_out = band_rows(x.shape[1], size, stride, padding, spatial.n_space,
                                       what)
        x = halo_pad(x, top, bottom, float('-inf'), spatial)
        pad_h = 0
    xc = _nchw(x)
    if padding:
        xc = F.pad(xc, (padding, padding, pad_h, pad_h), value=float('-inf'))
    out = _nhwc(F.max_pool2d(xc, size, stride))
    if h_out is not None:
        out = out[:, :h_out]
    return out.contiguous()


def adaptive_avg_pool(x, out_h: int, out_w: int, spatial=None, rows=None):
    """AdaptiveAvgPool2d with torch's bucket edges, on NHWC. With
    ``spatial`` ``x`` is a band of rows and only the global pool (1, 1)
    runs: the band sums are all-reduced over the space group, through the
    differentiable ``all_reduce_sum``, and divided by the global H*W (the
    real ``rows`` x W when the input was padded, its padded rows being 0);
    the result is replicated over the bands."""
    n, h, w, c = x.shape
    if spatial is not None:
        if (out_h, out_w) != (1, 1):
            raise ValueError(f'avgpool to {(out_h, out_w)} under train.spatial: only the global '
                             'pool (1, 1) runs on bands of rows')
        from pqdet_tpu_torch.parallel.mesh import all_reduce_sum
        sums = all_reduce_sum(x.float().sum(dim=(1, 2), keepdim=True), spatial.space)
        return (sums / ((h * spatial.n_space if rows is None else rows) * w)).to(x.dtype)
    if (out_h, out_w) == (1, 1):
        return x.mean(dim=(1, 2), keepdim=True)
    if h % out_h == 0 and w % out_w == 0:
        kh, kw = h // out_h, w // out_w
        return _nhwc(F.avg_pool2d(_nchw(x), (kh, kw), (kh, kw))).contiguous()
    ys = [(math.floor(i * h / out_h), math.ceil((i + 1) * h / out_h)) for i in range(out_h)]
    xs = [(math.floor(j * w / out_w), math.ceil((j + 1) * w / out_w)) for j in range(out_w)]
    rows = [torch.stack([x[:, y0:y1, x0:x1, :].mean(dim=(1, 2)) for x0, x1 in xs], dim=1)
            for y0, y1 in ys]
    return torch.stack(rows, dim=1)


def upsample_nearest(x, factor: int):
    """Nearest-neighbour upsample of NHWC by broadcast and reshape."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, factor, w, factor, c)
    return x.reshape(n, h * factor, w * factor, c)


def linear(x, params):
    return F.linear(x, params['w'], params['b'])


def dropout(x, rate: float, gen, train: bool = False):
    """Identity at inference; in training each element is kept with
    probability 1 - ``rate`` (a uniform draw from ``gen``, a generator on
    x's device) and scaled by 1 / (1 - rate)."""
    if not train or rate == 0.0:
        return x
    if gen is None:
        raise ValueError('train-mode dropout needs a torch.Generator (rng=)')
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
