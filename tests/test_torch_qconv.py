"""The int8 conv kernels' plain versions (``pqdet_tpu_torch/ops/qconv.py``)
against the JAX package's Pallas kernels run in interpret mode, on the same
numpy inputs and the same scalar vector.

Bounds: requantised s8 codes equal, or at most 1 code apart on under
0.1 % of the elements (the JAX package's own bound for the requant step,
tests/test_pallas.py); f32 outputs within 1e-5 * max(1, |r|). Both sides
sum exactly (s32 on the JAX side, float64 in the port) and run the same f32
epilogue, so what is left is the order of f32 roundings.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pqdet_tpu.ops.pallas_qconv import make_scalars as jax_make_scalars
from pqdet_tpu.ops.pallas_qconv import qconv1x1_s8 as jax_qconv1x1
from pqdet_tpu.ops.pallas_qconv import qdwconv3x3_s8 as jax_qdwconv3x3
from pqdet_tpu_torch.ops.qconv import (make_scalars, qconv1x1_reference,
                                       qconv1x1_s8, qdwconv3x3_reference,
                                       qdwconv3x3_s8)


def assert_codes_close(out, ref):
    """s8 codes equal, or 1 apart on under 0.1 % of the elements."""
    diff = np.abs(np.asarray(out, np.int32) - np.asarray(ref, np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, \
        f'{int((diff > 0).sum())} of {diff.size} codes differ, max {diff.max()}'


def assert_f32_close(out, ref):
    ref = np.asarray(ref, np.float32)
    tol = 1e-5 * np.maximum(1.0, np.abs(ref))
    assert (np.abs(np.asarray(out) - ref) <= tol).all(), np.abs(out - ref).max()


def _edges(rng, y):
    """An output edge (scale, zp) that spans ``y``, as act_qparams makes it."""
    mn, mx = min(float(y.min()), 0.0), max(float(y.max()), 0.0)
    scale = max((mx - mn) / 255.0, 1e-8)
    return scale, float(np.clip(np.round(-mn / scale), 0, 255))


def _pw_inputs(rng, n, h, w, cin, cout):
    x = rng.randint(-128, 128, (n, h, w, cin)).astype(np.int8)
    wq = rng.randint(-127, 128, (cin, cout)).astype(np.int8)
    w_scale = (rng.rand(cout) * 0.01 + 0.001).astype(np.float32)
    b = (rng.randn(cout) * 0.5).astype(np.float32)
    colsum = wq.astype(np.int32).sum(0)
    return x, wq, w_scale, b, colsum


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


PW_CASES = [
    # (n, h, w, cin, cout, act, x_zp): ragged Cin 24, the stem's K = 27, the
    # heads' ragged Cout 75, wide Cin, zero points 0 / 7 / 117 / 255
    (2, 4, 8, 24, 144, 'relu', 7.0),
    (1, 8, 8, 27, 32, 'relu', 117.0),
    (2, 4, 4, 64, 75, 'linear', 3.0),
    (1, 2, 2, 320, 96, 'linear', 0.0),
    (2, 4, 4, 16, 24, 'relu6', 255.0),
    (1, 4, 4, 32, 40, 'leaky', 60.0),
]


@pytest.mark.parametrize('case', PW_CASES, ids=lambda c: f'{c[3]}x{c[4]}-{c[5]}')
def test_qconv1x1_plain_matches_jax(case):
    n, h, w, cin, cout, act, x_zp = case
    rng = np.random.RandomState(cin * 1000 + cout)
    x, wq, w_scale, b, colsum = _pw_inputs(rng, n, h, w, cin, cout)
    x_scale = 0.02
    tx, tw, tws, tb, tcs = _torch(x, wq, w_scale, b, colsum)

    sc = make_scalars(x_scale, x_zp, device='cpu')
    ref = np.asarray(jax_qconv1x1(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(w_scale), jnp.asarray(b),
        jnp.asarray(colsum), act=act, scalars=jnp.asarray(jax_make_scalars(x_scale, x_zp)),
        requant=False, interpret=True))
    out = qconv1x1_reference(tx, tw, tws, tb, tcs, act=act, scalars=sc, requant=False)
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape == (n, h, w, cout)
    assert_f32_close(out.numpy(), ref)

    os_, ozp = _edges(rng, ref)
    sc = make_scalars(x_scale, x_zp, os_, ozp, device='cpu')
    np.testing.assert_array_equal(sc.numpy(), jax_make_scalars(x_scale, x_zp, os_, ozp))
    qref = np.asarray(jax_qconv1x1(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(w_scale), jnp.asarray(b),
        jnp.asarray(colsum), act=act, scalars=jnp.asarray(sc.numpy()),
        requant=True, interpret=True))
    q = qconv1x1_reference(tx, tw, tws, tb, tcs, act=act, scalars=sc, requant=True)
    assert q.dtype == torch.int8 and len(np.unique(qref)) > 20
    assert_codes_close(q.numpy(), qref)


DW_CASES = [
    # (n, h, w, c, stride, act, x_zp)
    (2, 8, 8, 32, 1, 'relu', 11.0),
    (2, 8, 12, 32, 2, 'relu', 11.0),
    (1, 6, 6, 24, 1, 'linear', 0.0),
    (1, 8, 4, 24, 2, 'linear', 200.0),
    (1, 5, 7, 6, 1, 'relu', 128.0),   # C % 4 != 0, odd H and W at stride 1
    (2, 4, 4, 144, 2, 'relu6', 255.0),
]


@pytest.mark.parametrize('case', DW_CASES, ids=lambda c: f'c{c[3]}-s{c[4]}-zp{int(c[6])}')
def test_qdwconv3x3_plain_matches_jax(case):
    n, h, w, c, stride, act, x_zp = case
    rng = np.random.RandomState(c * 10 + stride)
    x = rng.randint(-128, 128, (n, h, w, c)).astype(np.int8)
    wq = rng.randint(-127, 128, (3, 3, c)).astype(np.int8)
    w_scale = (rng.rand(c) * 0.01 + 0.001).astype(np.float32)
    b = (rng.randn(c) * 0.5).astype(np.float32)
    x_scale = 0.03
    tx, tw, tws, tb = _torch(x, wq, w_scale, b)

    def jax_dw(scalars, requant):
        return np.asarray(jax_qdwconv3x3(
            jnp.asarray(x), jnp.asarray(wq), jnp.asarray(w_scale), jnp.asarray(b),
            act=act, stride=stride, scalars=jnp.asarray(scalars), requant=requant,
            interpret=True))

    sc = make_scalars(x_scale, x_zp, device='cpu')
    ref = jax_dw(sc.numpy(), False)
    out = qdwconv3x3_reference(tx, tw, tws, tb, act=act, stride=stride, scalars=sc,
                               requant=False)
    assert tuple(out.shape) == ref.shape == (n, h // stride, w // stride, c)
    assert_f32_close(out.numpy(), ref)

    os_, ozp = _edges(rng, ref)
    sc = make_scalars(x_scale, x_zp, os_, ozp, device='cpu')
    qref = jax_dw(sc.numpy(), True)
    q = qdwconv3x3_reference(tx, tw, tws, tb, act=act, stride=stride, scalars=sc,
                             requant=True)
    assert q.dtype == torch.int8 and len(np.unique(qref)) > 20
    assert_codes_close(q.numpy(), qref)


def _small_pw():
    rng = np.random.RandomState(5)
    x, wq, w_scale, b, colsum = _pw_inputs(rng, 1, 2, 4, 24, 75)
    return _torch(x, wq, w_scale, b, colsum)


def test_wrappers_run_plain_versions_on_cpu():
    """On a CPU tensor each wrapper returns its plain version's result and
    launches nothing."""
    x, wq, w_scale, b, colsum = _small_pw()
    sc = make_scalars(0.05, 9.0, 0.1, 4.0, device='cpu')
    before = (qconv1x1_s8.launches, qdwconv3x3_s8.launches)
    got = qconv1x1_s8(x, wq, w_scale, b, colsum, act='relu', scalars=sc, requant=True)
    ref = qconv1x1_reference(x, wq, w_scale, b, colsum, act='relu', scalars=sc, requant=True)
    assert torch.equal(got, ref)
    xd = torch.from_numpy(np.random.RandomState(6).randint(-128, 128, (1, 4, 4, 8))
                          .astype(np.int8))
    wd = torch.from_numpy(np.random.RandomState(7).randint(-127, 128, (3, 3, 8))
                          .astype(np.int8))
    kw = dict(act='linear', stride=2, scalars=sc, requant=False)
    got = qdwconv3x3_s8(xd, wd, torch.ones(8), torch.zeros(8), **kw)
    assert torch.equal(got, qdwconv3x3_reference(xd, wd, torch.ones(8), torch.zeros(8), **kw))
    assert (qconv1x1_s8.launches, qdwconv3x3_s8.launches) == before


def test_wrappers_raise_off_cpu_and_cuda():
    x, wq, w_scale, b, colsum = _small_pw()
    meta = [t.to('meta') for t in (x, wq, w_scale, b, colsum)]
    with pytest.raises(ValueError, match='no kernel for device'):
        qconv1x1_s8(*meta, act='relu', scalars=torch.zeros(1, 4, device='meta'),
                    requant=True)
    xd = torch.zeros(1, 4, 4, 8, dtype=torch.int8, device='meta')
    with pytest.raises(ValueError, match='no kernel for device'):
        qdwconv3x3_s8(xd, torch.zeros(3, 3, 8, dtype=torch.int8, device='meta'),
                      torch.ones(8, device='meta'), torch.zeros(8, device='meta'),
                      act='relu', stride=1, scalars=torch.zeros(1, 4, device='meta'),
                      requant=True)


@pytest.mark.parametrize('hw', [(5, 4), (4, 7)])
def test_qdwconv3x3_stride2_needs_even_sizes(hw):
    """As the JAX kernel, stride 2 refuses an odd H or W."""
    x = np.zeros((1, *hw, 8), np.int8)
    w = np.zeros((3, 3, 8), np.int8)
    sc = make_scalars(0.1, 0.0, device='cpu')
    with pytest.raises(ValueError, match='even H/W'):
        jax_qdwconv3x3(jnp.asarray(x), jnp.asarray(w), jnp.ones(8), jnp.zeros(8),
                       act='relu', stride=2, scalars=jnp.asarray(sc.numpy()),
                       requant=False, interpret=True)
    with pytest.raises(ValueError, match='even H/W'):
        qdwconv3x3_s8(torch.from_numpy(x), torch.from_numpy(w), torch.ones(8),
                      torch.zeros(8), act='relu', stride=2, scalars=sc, requant=False)
