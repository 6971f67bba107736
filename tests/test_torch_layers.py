"""pqdet_tpu_torch layers and graph IR against the JAX package, layer by
layer, on the same numpy inputs (CPU, f32).

Tolerance: 1e-5 absolute and relative, f32 arithmetic on both sides with
sums taken in another order (JAX runs at 'highest' matmul precision,
tests/conftest.py)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pqdet_tpu.model import layers as JL
from pqdet_tpu.model.graph import Graph as JGraph
from pqdet_tpu.zoo.mobilenetv2 import mobilenetv2_fpn as jax_mobilenetv2_fpn
from pqdet_tpu_torch.bridge import hwio_to_oihw
from pqdet_tpu_torch.model import layers as L
from pqdet_tpu_torch.model.graph import Graph
from pqdet_tpu_torch.zoo import get_cfg

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize('name', sorted(JL.ACTIVATION_FNS))
def test_activation(name):
    x = np.random.RandomState(0).randn(4, 5, 6, 7).astype(np.float32) * 4
    ref = JL.apply_activation(name, jnp.asarray(x))
    out = L.apply_activation(name, torch.from_numpy(x))
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


@pytest.mark.parametrize('cin,cout,groups,size,stride,pad,dense', [
    (8, 16, 1, 3, 1, 1, False),    # plain 3x3
    (8, 16, 4, 3, 2, 1, False),    # grouped, stride 2
    (12, 12, 12, 3, 1, 1, False),  # depthwise
    (8, 8, 8, 3, 2, 1, False),     # depthwise, stride 2
    (8, 16, 4, 1, 1, 0, True),     # grouped, already densified
])
def test_conv2d(cin, cout, groups, size, stride, pad, dense):
    rng = np.random.RandomState(1)
    x = rng.randn(2, 9, 11, cin).astype(np.float32)
    w = rng.randn(size, size, cin // groups, cout).astype(np.float32) * 0.3
    b = rng.randn(cout).astype(np.float32)
    if dense:   # block-diagonal dense weights of a grouped conv
        w = np.asarray(JL.densify_grouped_weight(jnp.asarray(w), groups))
    ref = JL.conv2d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                    padding=pad, groups=groups)
    out = L.conv2d(torch.from_numpy(x), torch.from_numpy(hwio_to_oihw(w)),
                   torch.from_numpy(b), stride=stride, padding=pad, groups=groups)
    assert out.shape == ref.shape
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


def _bn(rng, c):
    p = {'gamma': rng.rand(c).astype(np.float32) + 0.5,
         'beta': rng.randn(c).astype(np.float32)}
    s = {'mean': rng.randn(c).astype(np.float32),
         'var': rng.rand(c).astype(np.float32) + 0.1}
    return p, s


def test_batch_norm_eval():
    rng = np.random.RandomState(2)
    x = rng.randn(2, 5, 5, 6).astype(np.float32)
    p, s = _bn(rng, 6)
    ref, _ = JL.batch_norm(jnp.asarray(x), p, s, train=False)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ts = {k: torch.from_numpy(v) for k, v in s.items()}
    out, _ = L.batch_norm(torch.from_numpy(x), tp, ts)
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


def test_fold_bn_into_conv_bit_exact_as_jax():
    """The fold equals JAX's (op by op, as ``convert_to_int8`` runs it) bit
    for bit on a thousand channels: its root is the correctly rounded one,
    which torch's f32 sqrt on the CPU misses in about 0.7 % of elements."""
    rng = np.random.RandomState(5)
    c = 1024
    w = rng.randn(1, 1, 3, c).astype(np.float32)
    p = {'gamma': rng.uniform(0.5, 1.5, c).astype(np.float32),
         'beta': rng.randn(c).astype(np.float32)}
    s = {'mean': rng.randn(c).astype(np.float32),
         'var': rng.uniform(1e-3, 4.0, c).astype(np.float32)}
    ref = JL.fold_bn_into_conv({'w': w}, p, s)
    out = L.fold_bn_into_conv({'w': torch.from_numpy(hwio_to_oihw(w))},
                              {k: torch.from_numpy(v) for k, v in p.items()},
                              {k: torch.from_numpy(v) for k, v in s.items()})
    np.testing.assert_array_equal(_np(out['w']), hwio_to_oihw(_np(ref['w'])))
    np.testing.assert_array_equal(_np(out['b']), _np(ref['b']))


def test_fold_bn_into_conv():
    rng = np.random.RandomState(3)
    w = rng.randn(3, 3, 4, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    p, s = _bn(rng, 6)
    for conv in ({'w': w}, {'w': w, 'b': b}):
        ref = JL.fold_bn_into_conv(conv, p, s)
        tconv = {'w': torch.from_numpy(hwio_to_oihw(conv['w']))}
        if 'b' in conv:
            tconv['b'] = torch.from_numpy(b)
        out = L.fold_bn_into_conv(tconv, {k: torch.from_numpy(v) for k, v in p.items()},
                                  {k: torch.from_numpy(v) for k, v in s.items()})
        np.testing.assert_allclose(_np(out['w']), hwio_to_oihw(_np(ref['w'])), **TOL)
        np.testing.assert_allclose(_np(out['b']), _np(ref['b']), **TOL)


@pytest.mark.parametrize('size,stride,pad', [(2, 2, 0), (3, 1, 1), (5, 1, 2), (3, 2, 1)])
def test_max_pool(size, stride, pad):
    x = np.random.RandomState(4).randn(2, 9, 10, 3).astype(np.float32) - 5.0
    ref = JL.max_pool(jnp.asarray(x), size, stride, pad)
    out = L.max_pool(torch.from_numpy(x), size, stride, pad)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(_np(out), _np(ref))


def test_upsample_nearest():
    x = np.random.RandomState(5).randn(2, 3, 4, 5).astype(np.float32)
    ref = JL.upsample_nearest(jnp.asarray(x), 2)
    out = L.upsample_nearest(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(_np(out), _np(ref))


@pytest.mark.parametrize('h,w,oh,ow', [(8, 8, 1, 1), (8, 12, 4, 3), (7, 10, 3, 4)])
def test_adaptive_avg_pool(h, w, oh, ow):
    """(1,1) mean, the divisible case and torch's bucket edges."""
    x = np.random.RandomState(6).randn(2, h, w, 3).astype(np.float32)
    ref = JL.adaptive_avg_pool(jnp.asarray(x), oh, ow)
    out = L.adaptive_avg_pool(torch.from_numpy(x), oh, ow)
    assert out.shape == ref.shape
    np.testing.assert_allclose(_np(out), _np(ref), **TOL)


@pytest.mark.parametrize('kw', [{}, {'width_mult': 0.5}, {'num_classes': 3}])
def test_graph_of_zoo_cfg(kw):
    """The port's cfg text, nodes, refs, strides and liveness equal JAX's."""
    cfg = get_cfg('mobilenetv2-fpn', **kw)
    jcfg = jax_mobilenetv2_fpn(**kw)
    assert cfg == jcfg
    g, jg = Graph.from_cfg(cfg), JGraph.from_cfg(jcfg)
    assert len(g) == len(jg) == 103
    for n, jn in zip(g.nodes, jg.nodes):
        assert (n.index, n.kind, n.attrs, n.in_channels, n.out_channels, n.stride,
                n.refs, n.notprune, n.out_size) == \
            (jn.index, jn.kind, jn.attrs, jn.in_channels, jn.out_channels,
             jn.stride, jn.refs, jn.notprune, jn.out_size)
    assert g.last_use == jg.last_use
    assert g.consumers == jg.consumers
    kinds = [n.kind for n in g.nodes]
    assert {k: kinds.count(k) for k in set(kinds)} == {
        'convolutional': 84, 'shortcut': 10, 'route': 4, 'upsample': 2, 'yolo': 3}
