"""The training slice's modules against the JAX package on the same seeded
numpy inputs (CPU, f32): the IoU family, device label assignment, the
per-scale YOLO loss, train-mode batch norm, dropout, the schedules; and
the kernel wrappers' refusal of tensors that require grad."""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pqdet_tpu.model import layers as JL
from pqdet_tpu.model.decode import decode as jax_decode
from pqdet_tpu.model.loss import loss_per_scale as jax_loss_per_scale
from pqdet_tpu.ops import boxes as jboxes
from pqdet_tpu.ops.labels import assign_labels_device as jax_assign
from pqdet_tpu.train import schedule as jsched
from pqdet_tpu_torch.config import Config
from pqdet_tpu_torch.model import layers as L
from pqdet_tpu_torch.model.loss import loss_per_scale
from pqdet_tpu_torch.ops import boxes
from pqdet_tpu_torch.ops.decode_kernel import decode_heads
from pqdet_tpu_torch.ops.fused_ir import fused_ir_conv
from pqdet_tpu_torch.ops.labels import assign_labels_device, label_assigner_from_config
from pqdet_tpu_torch.ops.qconv import qconv1x1_s8, qdwconv3x3_s8
from pqdet_tpu_torch.train import schedule

STRIDES = [8, 16, 32]
ANCHORS = np.array(Config().model.anchors, np.float32)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _boxes(rng, n, lo=0.0, span=60.0):
    xy = rng.rand(n, 2).astype(np.float32) * span + lo
    wh = rng.rand(n, 2).astype(np.float32) * 30 + 2
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


# ---------------------------------------------------------------- IoU family

@pytest.mark.parametrize('name', ['iou', 'giou', 'diou', 'ciou'])
def test_iou_family_values_and_grads(name):
    """Values and d/d(boxes1) of sum(f(boxes1, boxes2)), boxes2 with
    zero-padded rows (the padded label boxes). Bound: rtol 1e-5, atol
    1e-6 on values; rtol 1e-4, atol 1e-6 on grads (f32 both sides)."""
    rng = np.random.RandomState(0)
    b1 = _boxes(rng, 40).reshape(4, 10, 4)
    b2 = _boxes(rng, 40).reshape(4, 10, 4)
    b2[:, 7:] = 0.0                                   # padding rows
    b2[0, 0] = b1[0, 0] + 0.5                         # a near match
    jf, tf = getattr(jboxes, name), getattr(boxes, name)
    ref, gref = jax.value_and_grad(lambda a: jnp.sum(jf(a, jnp.asarray(b2))))(jnp.asarray(b1))
    ref_v = jf(jnp.asarray(b1), jnp.asarray(b2))
    t1 = torch.from_numpy(b1).requires_grad_(True)
    out = tf(t1, torch.from_numpy(b2))
    out.sum().backward()
    assert np.isfinite(_np(out)).all() and np.isfinite(_np(t1.grad)).all()
    np.testing.assert_allclose(_np(out), _np(ref_v), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(_np(t1.grad), _np(gref), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize('name', ['relu6', 'leaky', 'relu'])
def test_activation_subgradients_match_jax(name):
    """At the kinks (0, and 6 for relu6) and elsewhere, values and grads
    equal JAX's: the port takes JAX's subgradients under autograd."""
    x = np.array([-3.0, -0.0, 0.0, 0.5, 6.0, 7.5], np.float32)
    ref, gref = jax.vmap(jax.value_and_grad(lambda v: JL.apply_activation(name, v)))(
        jnp.asarray(x))
    t = torch.from_numpy(x).requires_grad_(True)
    out = L.apply_activation(name, t)
    out.sum().backward()
    np.testing.assert_array_equal(_np(out), _np(ref))
    np.testing.assert_array_equal(_np(t.grad), _np(gref))
    with torch.no_grad():
        np.testing.assert_array_equal(_np(L.apply_activation(name, torch.from_numpy(x))),
                                      _np(ref))


# ---------------------------------------------------------- label assignment

def _gt_case(case):
    """(gt (B, G, 6), input size, anchors) of one labelling case."""
    rng = np.random.RandomState(1)
    size, anchors = (64, 96), ANCHORS
    gt = np.zeros((3, 12, 6), np.float32)
    if case == 'random':
        for i in range(3):
            n = rng.randint(4, 13)
            b = _boxes(rng, n, lo=0, span=60)
            gt[i, :n] = np.concatenate([b, rng.randint(0, 5, (n, 1)), rng.rand(n, 1)], 1)
    elif case == 'contended':       # boxes of one centre cell and anchor: the last wins
        for i in range(3):
            for g in range(6):
                d = 0.5 * g
                gt[i, g] = [20 + d, 20, 36 + d, 33, g % 5, 0.5 + 0.05 * g]
    elif case == 'padding':         # real rows between zero rows
        gt[0, 2] = [10, 10, 40, 50, 1, 1.0]
        gt[1, 5] = [30, 4, 60, 20, 3, 0.7]
        gt[2, 11] = [0, 0, 64, 96, 4, 1.0]
    elif case == 'off_grid':        # centres outside the input, valid boxes
        gt[0, :3] = [[-40, 10, -10, 40, 0, 1.0], [70, 10, 90, 40, 1, 1.0],
                     [10, 100, 30, 130, 2, 1.0]]
        gt[1, :2] = [[-5, -5, 3, 3, 3, 1.0], [60, 90, 70, 100, 4, 1.0]]
        gt[2, 0] = [10, 10, 30, 30, 0, 1.0]
    elif case == 'fallback_ties':   # no anchor over the threshold; equal anchors tie
        anchors = np.tile(np.array([[10, 13], [10, 13], [16, 30]], np.float32), (3, 1))
        for i in range(3):
            gt[i, :4] = [[8, 8, 10, 10, 0, 1.0], [30, 30, 31, 60, 1, 1.0],
                         [40, 40, 43, 43, 2, 1.0], [1, 50, 63, 51, 3, 1.0]]
    return gt, size, anchors


@pytest.mark.parametrize('case', ['random', 'contended', 'padding', 'off_grid',
                                  'fallback_ties'])
def test_assign_labels_device_matches_jax(case):
    """The six outputs (3 grids, 3 box lists) equal JAX's exactly."""
    gt, size, anchors = _gt_case(case)
    ref = jax_assign(jnp.asarray(gt), size, STRIDES, anchors, 5)
    out = assign_labels_device(torch.from_numpy(gt), size, STRIDES, anchors, 5)
    assert len(out) == 6
    for r, o in zip(ref, out):
        assert o.dtype == torch.float32 and tuple(o.shape) == r.shape
        np.testing.assert_array_equal(_np(o), _np(r))
    assert any(_np(o)[..., 4].any() for o in out[:3]) or case == 'off_grid'


def test_label_assigner_from_config():
    """The config closure gives assign_labels_device's grids, on the
    device it was built for."""
    gt, size, _ = _gt_case('random')
    fn = label_assigner_from_config(Config(), device='cpu')
    out = fn(torch.from_numpy(gt), size)
    ref = jax_assign(jnp.asarray(gt), size, STRIDES, ANCHORS, 20)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(_np(o), _np(r))


# ------------------------------------------------------------------- loss

def _loss_inputs():
    """Decoded preds of one stride-8 head at 64x64 (B=2, A=3, C=4), its JAX
    label grid and box list."""
    rng = np.random.RandomState(2)
    raw = (rng.randn(2, 8, 8, 27) * 0.8).astype(np.float32)
    pred = np.array(jax_decode(jnp.asarray(raw), 4, 8))
    gt = np.zeros((2, 10, 6), np.float32)
    for i in range(2):
        b = _boxes(rng, 8, lo=2, span=40)
        gt[i, :8] = np.concatenate([b, rng.randint(0, 4, (8, 1)), rng.rand(8, 1) + 0.5], 1)
    t = jax_assign(jnp.asarray(gt), (64, 64), STRIDES, ANCHORS, 4)
    return pred, np.array(t[0]), np.array(t[3])


@pytest.mark.parametrize('bbox_loss', ['giou', 'diou', 'ciou', 'iou', 'l1'])
def test_loss_per_scale_matches_jax(bbox_loss):
    """The four outputs (rtol 1e-5) and d/d(pred) of bbox + 2 conf + 3 prob
    (rtol 1e-4, atol 1e-6 * max |grad|), f32."""
    pred, label, gtb = _loss_inputs()
    kw = dict(stride=8, num_classes=4, bbox_loss_type=bbox_loss, ignore_thresh=0.3)
    assert label[..., 4].sum() > 0

    def jf(p):
        return jax_loss_per_scale(p, jnp.asarray(label), jnp.asarray(gtb), **kw)
    ref = jf(jnp.asarray(pred))
    gref = jax.grad(lambda p: (lambda o: o[1] + 2 * o[2] + 3 * o[3])(jf(p))[0])(
        jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_(True)
    out = loss_per_scale(tp, torch.from_numpy(label), torch.from_numpy(gtb), **kw)
    (out[1] + 2 * out[2] + 3 * out[3])[0].backward()
    for o, r in zip(out, ref):
        assert tuple(o.shape) == (1,)
        np.testing.assert_allclose(_np(o), _np(r), rtol=1e-5)
    g, gr = _np(tp.grad), _np(gref)
    assert np.abs(gr).max() > 0 and np.isfinite(g).all()
    np.testing.assert_allclose(g, gr, rtol=1e-4, atol=1e-6 * np.abs(gr).max())


def test_loss_ignore_mask_takes_both_values():
    """The inputs of the loss test put some background anchors over the
    ignore threshold and some under, so the mask is exercised."""
    pred, label, gtb = _loss_inputs()
    best = _np(boxes.iou(torch.from_numpy(pred[..., None, :4]),
                         torch.from_numpy(gtb[:, None, None, None]))).max(-1)
    bg = label[..., 4] == 0
    assert (best[bg] >= 0.3).any() and (best[bg] < 0.3).any()


# ---------------------------------------------------------- batch norm

@pytest.mark.parametrize('shape', [(4, 17, 19, 6), (2, 2, 2, 5)])
def test_batch_norm_train_matches_jax(shape):
    """y, new running statistics, and d/d(x, gamma, beta) of sum(y * r).
    Bounds: y and state rtol 1e-5, atol 1e-5; grads rtol 1e-4, atol 1e-5
    (f32 both sides). x has a large offset, which the shifted one-pass
    moments must absorb."""
    rng = np.random.RandomState(3)
    c = shape[-1]
    x = (rng.randn(*shape) * 2 + 5).astype(np.float32)
    r = rng.randn(*shape).astype(np.float32)
    p = {'gamma': rng.rand(c).astype(np.float32) + 0.5, 'beta': rng.randn(c).astype(np.float32)}
    s = {'mean': rng.randn(c).astype(np.float32), 'var': rng.rand(c).astype(np.float32) + 0.1}

    def jf(x, gamma, beta):
        y, ns = JL.batch_norm(x, {'gamma': gamma, 'beta': beta},
                              {k: jnp.asarray(v) for k, v in s.items()}, True)
        return jnp.sum(y * r), (y, ns)
    (_, (y, ns)), grads = jax.value_and_grad(jf, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x), jnp.asarray(p['gamma']), jnp.asarray(p['beta']))

    tx, tg, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, p['gamma'], p['beta']))
    ts = {k: torch.from_numpy(v) for k, v in s.items()}
    ty, tns = L.batch_norm(tx, {'gamma': tg, 'beta': tb}, ts, train=True)
    (ty * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(_np(ty), _np(y), rtol=1e-5, atol=1e-5)
    for k in ('mean', 'var'):
        assert not tns[k].requires_grad
        np.testing.assert_allclose(_np(tns[k]), _np(ns[k]), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(_np(ts['mean']), s['mean'])     # not written in place
    for t, g in zip((tx, tg, tb), grads):
        np.testing.assert_allclose(_np(t.grad), _np(g), rtol=1e-4, atol=1e-5)


def test_batch_norm_train_bf16_matches_jax():
    """bf16 x: moments in f32, y in bf16; y within 2 bf16 ulps of JAX's
    (rtol 2**-7), state rtol 1e-5."""
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 16, 16, 8) + 3).astype(np.float32)
    p = {'gamma': rng.rand(8).astype(np.float32) + 0.5, 'beta': rng.randn(8).astype(np.float32)}
    s = {'mean': np.zeros(8, np.float32), 'var': np.ones(8, np.float32)}
    y, ns = JL.batch_norm(jnp.asarray(x, jnp.bfloat16), p, s, True)
    ty, tns = L.batch_norm(torch.from_numpy(x).to(torch.bfloat16),
                           {k: torch.from_numpy(v) for k, v in p.items()},
                           {k: torch.from_numpy(v) for k, v in s.items()}, train=True)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(ty.float()), np.asarray(y, np.float32), rtol=2 ** -7,
                               atol=2 ** -7)
    for k in ('mean', 'var'):
        np.testing.assert_allclose(_np(tns[k]), _np(ns[k]), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- dropout

def test_dropout_statistics():
    """Masks differ between jax.random and torch.Generator, so only the
    statistics are compared: the kept share within 5 sigma of 1 - rate on
    both sides, every kept value scaled by exactly 1 / (1 - rate), and a
    generator with the same seed draws the same mask."""
    rate, n = 0.3, 200_000
    x = np.ones((4, 50, 100, 10), np.float32)
    ref = np.asarray(JL.dropout(jnp.asarray(x), rate, jax.random.PRNGKey(0), True))
    out = _np(L.dropout(torch.from_numpy(x), rate, torch.Generator().manual_seed(0), True))
    again = _np(L.dropout(torch.from_numpy(x), rate, torch.Generator().manual_seed(0), True))
    sigma = math.sqrt(rate * (1 - rate) / n)
    for a in (ref, out):
        assert abs((a != 0).mean() - (1 - rate)) < 5 * sigma
        np.testing.assert_array_equal(np.unique(a), np.array([0, 1 / (1 - rate)], np.float32))
    np.testing.assert_array_equal(out, again)
    assert L.dropout(torch.from_numpy(x), rate, None, False) is not None
    with pytest.raises(ValueError, match='Generator'):
        L.dropout(torch.from_numpy(x), rate, None, True)


# -------------------------------------------------------------- schedules

@pytest.mark.parametrize('kind', ['cosine', 'step'])
def test_schedules_match_jax(kind):
    """At warmup, at the boundaries and at the end: rtol 1e-6, atol 1e-8 of
    the initial lr (JAX computes in f32, the port in Python floats)."""
    if kind == 'cosine':
        args = (1e-3, 1e-6, 100, 1000)
        steps = [0, 1, 50, 99, 100, 101, 550, 999, 1000, 1200]
    else:
        args = (1e-3, 10, 10, [3, 5], 0.1)
        steps = [0, 5, 9, 10, 29, 30, 31, 49, 50, 80]
    jf = getattr(jsched, f'{kind}_warmup' if kind == 'cosine' else 'step_decay_warmup')(*args)
    tf = getattr(schedule, f'{kind}_warmup' if kind == 'cosine' else 'step_decay_warmup')(*args)
    for k in steps:
        assert isinstance(tf(k), float)
        np.testing.assert_allclose(tf(k), float(jf(k)), rtol=1e-6, atol=1e-11, err_msg=str(k))
    assert tf(0) == 0.0


def test_build_schedule():
    cfg = Config()
    cfg.train.warmup_epochs, cfg.train.max_epochs = 1.0, 4
    s = schedule.build_schedule(cfg, steps_per_epoch=10)
    assert s(0) == 0.0 and s(10) == pytest.approx(2e-4) and s(40) == pytest.approx(1e-6)
    cfg.train.scheduler = 'step'
    s = schedule.build_schedule(cfg, steps_per_epoch=1)
    assert s(31) == pytest.approx(2e-5) and s(46) == pytest.approx(2e-6)
    cfg.train.scheduler = 'poly'
    with pytest.raises(ValueError):
        schedule.build_schedule(cfg, 10)


# ------------------------------------------------------ kernels refuse grad

def _wrapper_calls(dev, requires_grad):
    f = dict(device=dev)
    g = dict(device=dev, requires_grad=requires_grad)
    sc = torch.zeros(1, 4, **f)
    return {
        'decode_heads': lambda: decode_heads([torch.zeros(1, 2, 2, 27, **g)], 4, [8], [0.0]),
        'fused_ir_conv': lambda: fused_ir_conv(
            torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16, **g), None, None,
            torch.zeros(9, 8, dtype=torch.bfloat16, **f), torch.zeros(8, **f),
            torch.zeros(8, 8, dtype=torch.bfloat16, **f), torch.zeros(8, **f),
            act_e='linear'),
        'qconv1x1_s8': lambda: qconv1x1_s8(
            torch.zeros(1, 2, 2, 16, dtype=torch.int8, **f),
            torch.zeros(16, 8, dtype=torch.int8, **f), torch.ones(8, **g),
            torch.zeros(8, **f), torch.zeros(8, dtype=torch.int32, **f), act='relu',
            scalars=sc, requant=False),
        'qdwconv3x3_s8': lambda: qdwconv3x3_s8(
            torch.zeros(1, 4, 4, 16, dtype=torch.int8, **f),
            torch.zeros(3, 3, 16, dtype=torch.int8, **f), torch.ones(16, **f),
            torch.zeros(16, **g), act='relu', stride=1, scalars=sc, requant=False),
    }


@pytest.mark.parametrize('name', ['decode_heads', 'fused_ir_conv', 'qconv1x1_s8',
                                  'qdwconv3x3_s8'])
def test_kernel_wrapper_refuses_grad(name):
    """Off the CPU (a meta tensor stands in for the card) a wrapper raises
    RuntimeError when grad mode is on and an input requires grad; under
    no_grad it goes on to its device check. On the CPU it runs its plain
    version, which stays differentiable where its inputs are float."""
    with pytest.raises(RuntimeError, match='no backward'):
        _wrapper_calls('meta', True)[name]()
    with torch.no_grad(), pytest.raises(ValueError, match='no kernel for device meta'):
        _wrapper_calls('meta', True)[name]()
    out = _wrapper_calls('cpu', True)[name]()
    assert out.requires_grad and out.grad_fn is not None
