"""pqdet_tpu_torch box recovery and NMS against the JAX package, on
identical recovered inputs with no tied scores (so the candidate order is
defined and equal on both sides).

Tolerances: recovery 1e-5 relative / 1e-4 px absolute (the same f32
operations in the same order); hard NMS keeps the same rows, bit for bit
(it only selects and gathers); soft-NMS scores 1e-6 absolute (a product
of f32 exp decays taken in the same order)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pqdet_tpu.ops import postprocess as JP
from pqdet_tpu_torch.ops import postprocess as P
from pqdet_tpu_torch.ops.boxes import iou


def _preds(rng, b, n, c, size=512):
    xy = rng.rand(b, n, 2) * size
    wh = rng.rand(b, n, 2) * 120 + 4
    coor = np.concatenate([xy - wh / 2, xy + wh / 2], -1)
    conf = rng.rand(b, n, 1)
    prob = rng.rand(b, n, c)
    return np.concatenate([coor, conf, prob], -1).astype(np.float32)


SHAPES = np.array([[375, 500], [480, 640], [512, 300]], np.float32)


@pytest.mark.parametrize('affine', ['letterbox', 'ratio_pad'])
def test_recover_bboxes(affine):
    pred = _preds(np.random.RandomState(0), 3, 50, 4)
    input_size = np.array([512, 512], np.float32)
    jaff = {'letterbox': JP.letterbox_affine, 'ratio_pad': JP.ratio_pad_affine}[affine]
    taff = {'letterbox': P.letterbox_affine, 'ratio_pad': P.ratio_pad_affine}[affine]
    ref = np.asarray(JP.recover_bboxes(jnp.asarray(pred), jnp.asarray(input_size),
                                       jnp.asarray(SHAPES), affine=jaff))
    out = P.recover_bboxes(torch.from_numpy(pred), torch.from_numpy(input_size),
                           torch.from_numpy(SHAPES), affine=taff).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)


def _boxes_scores(seed, b=2, n=120, c=3):
    """Clustered boxes (so suppression happens) with distinct scores."""
    rng = np.random.RandomState(seed)
    centres = rng.rand(b, 12, 2) * 400 + 50
    pick = rng.randint(0, 12, (b, n))
    xy = np.take_along_axis(centres, pick[..., None], 1) + rng.randn(b, n, 2) * 6
    wh = rng.rand(b, n, 2) * 40 + 30
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1)
    scores = np.stack([rng.permutation(n * c) for _ in range(b)]).reshape(b, n, c)
    scores = (scores + 0.5) / (n * c)       # distinct, in (0, 1)
    return np.concatenate([boxes, scores], -1).astype(np.float32)


def _assert_same(res, ref):
    for name in ('boxes', 'scores', 'classes', 'valid', 'overflow'):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)


@pytest.mark.parametrize('max_outputs,pool_factor,thr,overflow', [
    (32, 4, 0.7, False),   # the pool of 128 holds all 108 candidates
    (8, 2, 0.1, True),     # overflowing pool: 324 pairs clear 0.1, pool 16
    (300, 4, 0.5, False),  # output larger than the candidate set
])
def test_nms_batch(max_outputs, pool_factor, thr, overflow):
    bs = _boxes_scores(1)
    ref = JP.nms_batch(jnp.asarray(bs), thr, 0.45, max_outputs, pool_factor)
    res = P.nms_batch(torch.from_numpy(bs), thr, 0.45, max_outputs, pool_factor)
    _assert_same(res, ref)
    assert res.overflow.tolist() == [overflow] * bs.shape[0]
    n_cand = int((bs[..., 4:] > thr).sum())
    assert 0 < int(res.valid.sum()) < n_cand   # something was suppressed
    for i in range(bs.shape[0]):
        one = P.nms_single(torch.from_numpy(bs[i]), thr, 0.45, max_outputs, pool_factor)
        jone = JP.nms_single(jnp.asarray(bs[i]), thr, 0.45, max_outputs, pool_factor)
        _assert_same(one, jone)
        np.testing.assert_array_equal(P.nms_to_numpy(one), JP.nms_to_numpy(jone))


def test_nms_suppresses_overlaps():
    """Kept boxes of one class overlap below the IoU threshold."""
    bs = torch.from_numpy(_boxes_scores(2))
    res = P.nms_single(bs[0], 0.2, 0.45, 64)
    for cls in res.classes[res.valid].unique():
        keep = res.boxes[res.valid & (res.classes == cls)]
        m = iou(keep[:, None], keep[None])
        assert (m.fill_diagonal_(0) <= 0.45).all()


def test_soft_nms():
    bs = _boxes_scores(3, n=60)
    ref = JP.nms_batch(jnp.asarray(bs), 0.2, 0.45, 24, 4, method='soft-nms', sigma=0.3)
    res = P.nms_batch(torch.from_numpy(bs), 0.2, 0.45, 24, 4, method='soft-nms', sigma=0.3)
    for name in ('boxes', 'classes', 'valid', 'overflow'):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(res.scores.numpy(), np.asarray(ref.scores), atol=1e-6)
