"""The whole slice, pqdet_tpu_torch against the JAX package, on weights made
by JAX ``net.init`` and carried across with ``bridge.from_jax_params``:
the mobilenetv2-fpn forward in f32, the bf16 walk with the fused-IR table,
and the predict pipeline (normalize -> forward -> recover -> NMS).

The weights are JAX's init with every conv weight scaled by 2 and the
three head convs by another ``head_gain``: at the plain init the
activations fade through the depth and every score sits near 0.25, which
would make the comparison weak. With the gain, scores spread and boxes
vary. The bf16 comparison keeps a head gain of 1: two bf16 walks round at
other places, and a larger head gain amplifies that into the boxes.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pqdet_tpu.config import default_config
from pqdet_tpu.evaluation.predict import build_predict_pipeline as jax_pipeline
from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
from pqdet_tpu.model.network import fuse_params as jax_fuse_params
from pqdet_tpu.ops.boxes import iou as jax_iou
from pqdet_tpu.ops.pallas_fused import prepare_fused_ir as jax_prepare_fused_ir
from pqdet_tpu.ops.postprocess import recover_bboxes as jax_recover
from pqdet_tpu.ops.preprocess import device_normalize as jax_normalize
from pqdet_tpu.zoo import get_cfg as jax_get_cfg
from pqdet_tpu_torch.bridge import from_jax_params
from pqdet_tpu_torch.config import Config
from pqdet_tpu_torch.evaluation.predict import (build_predict_pipeline,
                                                make_batch_predict)
from pqdet_tpu_torch.model.decode import decode
from pqdet_tpu_torch.model.network import (DetectionNetwork, Network, cast_params,
                                           fuse_params)
from pqdet_tpu_torch.ops.fused_ir import prepare_fused_ir
from pqdet_tpu_torch.ops.boxes import iou
from pqdet_tpu_torch.ops.postprocess import recover_bboxes
from pqdet_tpu_torch.ops.preprocess import device_normalize

SIZE = 64
SHAPES = np.array([[375., 500.], [480., 360.]], np.float32)


def _images():
    return np.random.RandomState(0).randint(0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8)


def _jax_weights(num_classes, head_gain):
    cfg = jax_get_cfg('mobilenetv2-fpn', num_classes=num_classes)
    jnet = JaxNetwork.from_cfg(cfg)
    params, state = jnet.init(jax.random.PRNGKey(0))
    heads = {str(n.index - 1) for n in jnet.graph.yolo_nodes}
    params = {k: {**v, 'w': v['w'] * 2.0 * (head_gain if k in heads else 1.0)}
              for k, v in params.items()}
    return cfg, jnet, params, state


def _model(num_classes, head_gain):
    cfg, jnet, params, state = _jax_weights(num_classes, head_gain)
    net = DetectionNetwork.from_cfg(cfg)
    tp, ts = from_jax_params(params, state, net.graph, device='cpu')
    return jnet, params, state, net, tp, ts


@pytest.fixture(scope='module')
def model20():
    return _model(20, head_gain=30.0)


def test_forward_f32_matches_jax(model20):
    """Bounds: scores (cols 4:) 1e-4, boxes 1e-3 * max|box| (f32 on both
    sides; sums in another order through 84 convs)."""
    jnet, params, state, net, tp, ts = model20
    x = np.array(jax_normalize(jnp.asarray(_images())))
    ref = np.asarray(jax.jit(lambda p, s, x: jnet.apply(p, s, x)[0])(params, state, x))
    with torch.inference_mode():
        out = net(tp, ts, device_normalize(torch.from_numpy(_images()))).numpy()
    assert out.shape == ref.shape == (2, (8 * 8 + 4 * 4 + 2 * 2) * 3, 25)
    assert ref[..., 4:].max() - ref[..., 4:].min() > 0.5      # a spread of scores
    np.testing.assert_allclose(out[..., 4:], ref[..., 4:], atol=1e-4, rtol=0)
    np.testing.assert_allclose(out[..., :4], ref[..., :4],
                               atol=1e-3 * np.abs(ref[..., :4]).max(), rtol=0)


def test_fuse_params_matches_jax(model20):
    jnet, params, state, net, tp, ts = model20
    ref = jax_fuse_params(jnet, params, state)
    out = fuse_params(net, tp, ts)
    assert sorted(out) == sorted(ref)
    for k in ref:
        w = np.asarray(ref[k]['w']).transpose(3, 2, 0, 1)
        np.testing.assert_allclose(out[k]['w'].numpy(), w, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(out[k]['b'].numpy(), np.asarray(ref[k]['b']),
                                   rtol=1e-6, atol=1e-6)


def test_bf16_fused_walk_matches_jax():
    """The port's bf16 walk with its fused-IR table (the kernel's plain
    version on the CPU), and without it, against JAX's bf16 walk with the
    Pallas kernel in interpret mode; bounds of tests/test_pallas_fused.py:
    scores 0.03, boxes 1.5 px."""
    jnet, params, state, net, tp, ts = _model(20, head_gain=1.0)
    x = np.array(jax_normalize(jnp.asarray(_images())))
    jfused = jax_fuse_params(jnet, params, state)
    jtable = jax_prepare_fused_ir(jnet, jfused, interpret=True)
    ref = np.asarray(jax.jit(lambda p, x: jnet.apply(
        p, {}, x, compute_dtype=jnp.bfloat16, fused_ir=jtable)[0])(jfused, x), np.float32)
    fused = fuse_params(net, tp, ts)
    table = prepare_fused_ir(net, fused)
    assert sorted(table) == sorted(jtable) and len(table) == 21
    with torch.inference_mode():
        out = net(cast_params(fused, torch.bfloat16), {}, torch.from_numpy(x),
                  compute_dtype=torch.bfloat16, fused_ir=table).numpy()
        walk = net(cast_params(fused, torch.bfloat16), {}, torch.from_numpy(x),
                   compute_dtype=torch.bfloat16).numpy()
    for o in (out, walk):
        np.testing.assert_allclose(o[..., 4:], ref[..., 4:], atol=0.03, rtol=0)
        np.testing.assert_allclose(o[..., :4], ref[..., :4], atol=1.5, rtol=0)


def test_predict_pipeline_matches_jax():
    """Port's build_predict_pipeline against JAX's on the same uint8 batch
    and original shapes: equal detection counts and classes, boxes close.

    Why this cannot flake: with 2 classes and a score threshold of 0.85,
    12-15 (box, class) pairs per image are candidates. The test measures
    the port's recovered scores and candidate IoUs against JAX's, and then
    asserts that every decision NMS takes has a margin of at least 50
    times that error: the candidates' scores are that far from each other
    and from the threshold, and the IoU of every same-class candidate pair
    is that far from the IoU threshold. Greedy NMS is then the same sequence of
    decisions on both sides, whatever the last bits of the arithmetic."""
    jnet, params, state, net, tp, ts = _model(2, head_gain=30.0)
    # the pipelines serve BN-folded params
    jparams, tparams = jax_fuse_params(jnet, params, state), fuse_params(net, tp, ts)
    thr, iou_thr, max_det = 0.85, 0.45, 32

    jcfg = default_config()
    jcfg.eval.input_size = SIZE
    jcfg.eval.score_threshold = thr
    jcfg.eval.max_detections = max_det
    cfg = Config()
    cfg.eval.input_size = SIZE
    cfg.eval.score_threshold = thr
    cfg.eval.max_detections = max_det

    # the recovered candidates of both sides, for the margins
    jrec = np.asarray(jax_recover(
        jax.jit(lambda p, x: jnet.apply(p, {}, jax_normalize(x))[0])(
            jparams, jnp.asarray(_images())),
        jnp.asarray([SIZE, SIZE], jnp.float32), jnp.asarray(SHAPES)))
    with torch.inference_mode():
        trec = recover_bboxes(net(tparams, {}, device_normalize(torch.from_numpy(_images()))),
                              torch.tensor([SIZE, SIZE], dtype=torch.float32),
                              torch.from_numpy(SHAPES)).numpy()
    score_err = np.abs(trec[..., 4:] - jrec[..., 4:]).max()
    assert score_err < 1e-5, score_err
    for i in range(2):
        sc = jrec[i, :, 4:]
        assert np.abs(sc - thr).min() > 50 * score_err
        cand = np.argwhere(sc > thr)
        s = np.sort(sc[sc > thr])
        assert 5 <= len(s) <= max_det and np.diff(s).min() > 50 * score_err
        b, c = jrec[i, cand[:, 0], :4], cand[:, 1]
        m = np.asarray(jax_iou(jnp.asarray(b[:, None]), jnp.asarray(b[None])))
        tb = torch.from_numpy(trec[i, cand[:, 0], :4])
        tm = iou(tb[:, None], tb[None]).numpy()
        same = (c[:, None] == c[None]) & ~np.eye(len(c), dtype=bool)
        iou_err = max(np.abs(tm - m)[same].max(), 1e-6)
        assert np.abs(m[same] - iou_thr).min() > 50 * iou_err

    jrun = jax_pipeline(jnet, jcfg)
    jres = jrun(jparams, jnp.asarray(_images()), jnp.asarray(SHAPES))
    run = build_predict_pipeline(net, cfg, device='cpu')
    predict = make_batch_predict(run, tparams)
    dets = predict({'image': _images(), 'shape': SHAPES, 'count': 2})
    assert not np.asarray(jres.overflow).any()
    for i in range(2):
        keep = np.asarray(jres.valid[i])
        ref = np.concatenate([np.asarray(jres.boxes[i])[keep],
                              np.asarray(jres.scores[i])[keep, None],
                              np.asarray(jres.classes[i])[keep, None]], 1)
        assert dets[i].shape == ref.shape and len(ref) > 0
        np.testing.assert_array_equal(dets[i][:, 5], ref[:, 5])
        np.testing.assert_allclose(dets[i][:, :4], ref[:, :4],
                                   atol=1e-3 * np.abs(ref[:, :4]).max())
        np.testing.assert_allclose(dets[i][:, 4], ref[:, 4], atol=1e-5)


def test_later_slices_raise(model20):
    """The space-to-depth stem belongs to a later slice and raises, naming
    it; an unknown option is a TypeError. The QAT training walk, which
    raised before its slice, runs: it observes every edge and gives finite
    losses; with s2d_stem or remat segments it raises ValueError, as JAX's
    ``apply`` does."""
    from pqdet_tpu_torch.compress.qat import QuantCtx, prepare_qat_state
    *_, net, tp, ts = model20
    x = torch.zeros(1, 32, 32, 3)
    with pytest.raises(NotImplementedError, match='space-to-depth slice comes in a later slice'):
        net(tp, ts, x, s2d_stem=2)
    _, qs = prepare_qat_state(net, tp, ts)
    for bad in ({'s2d_stem': 2}, {'remat_segments': 2}):
        with pytest.raises(ValueError, match='quant_ctx'):
            net.forward_train(tp, qs, x, quant_ctx=QuantCtx(qs['quant']), **bad)
    ctx = QuantCtx(qs['quant'])
    # a seeded input: at head gain 30 the raw box offsets reach ~80, where
    # exp overflows to inf on about one uniform draw in eight (JAX's walk on
    # some of the same draws); the global generator made it depend on the
    # tests that ran before in the process
    xr = torch.rand(1, 32, 32, 3, generator=torch.Generator().manual_seed(0))
    preds, new_state = net.forward_train(tp, qs, xr, quant_ctx=ctx)
    assert bool(torch.isfinite(preds).all()) and set(new_state) >= set(ts)
    assert all(bool(o['initialized']) for o in ctx.new_obs.values())
    with pytest.raises(TypeError):
        net(tp, ts, x, no_such_option=1)


def test_network_forward_heads_are_views_of_the_preds(model20):
    """``Network.forward`` returns each head as (B, H, W, A, 5+C), views of
    the one preds tensor the decode writes, which ``DetectionNetwork``
    returns whole: the same values both ways."""
    *_, net, tp, ts = model20
    x = device_normalize(torch.from_numpy(_images()))
    with torch.inference_mode():
        heads = Network.forward(net, tp, ts, x)
        preds = net(tp, ts, x)
    want = [(2, SIZE // y.attrs['stride'], SIZE // y.attrs['stride'], 3, 25)
            for y in net.graph.yolo_nodes]
    assert [tuple(h.shape) for h in heads] == want == [(2, 2, 2, 3, 25), (2, 4, 4, 3, 25),
                                                         (2, 8, 8, 3, 25)]
    assert len({h.untyped_storage().data_ptr() for h in heads}) == 1
    assert torch.equal(torch.cat([h.reshape(2, -1, 25) for h in heads], 1), preds)


READ_YOLO_CFG = """[net]
channels=3

[convolutional]
filters=18
size=1
stride=2
pad=1
activation=linear

[yolo]
mask=0,1,2
anchors=10,13,16,30,33,23
classes=1

[route]
layers=-1
"""


def test_a_graph_that_reads_a_yolo_output():
    """No zoo graph reads a yolo node's output; one that does decodes that
    head in the walk on the plain path (CPU tensors), and raises naming the
    node on the kernel path (a meta tensor stands in for the card), since
    the kernel decodes every head after the walk."""
    net = DetectionNetwork.from_cfg(READ_YOLO_CFG)
    assert 1 in net.graph.last_use                   # the route reads yolo node 1
    params, state = net.init(torch.Generator().manual_seed(0), device='cpu')
    x = torch.randn(1, 8, 8, 3, generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        preds = net(params, state, x)
        raw = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), params['0']['w'],
                                         params['0']['b'], 2).permute(0, 2, 3, 1)
    assert preds.shape == (1, 4 * 4 * 3, 6)
    torch.testing.assert_close(preds, decode(raw, 1, 2).reshape(1, -1, 6))
    meta = {k: {n: t.to('meta') for n, t in v.items()} for k, v in params.items()}
    with pytest.raises(NotImplementedError, match='yolo node 1 is read'):
        net(meta, {}, x.to('meta'))
