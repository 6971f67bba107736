"""The int8 serving slice, pqdet_tpu_torch against the JAX package on the
quant graph of mobilenetv2-fpn at width 0.25, 64x64, batch 2: calibration
(QAT observers), ``convert_to_int8``, ``Int8Inference`` in the port's
``kernel`` mode (the kernels' plain versions on the CPU) against JAX's
``pallas`` mode (Pallas kernels in interpret mode), ``int`` mode against
``int`` mode, and the predict pipeline.

Weights: JAX's init with every conv weight scaled by 1.5 and seeded BN
statistics, so the folded biases are nonzero and the scores spread. The
JAX side calibrates with two observer passes under ``jax.jit`` and its
qparams are carried across with ``bridge.from_jax_qparams``.

Why the whole-net bounds are JAX's own (scores 2e-2, boxes 0.5 px,
tests/test_qat.py): XLA on the CPU contracts the epilogue's
``acc * alpha + b`` into one FMA, where the port, like the kernel's
written order, rounds the product and the sum apart. That flips a
requantised code by one now and then, and a random net carries the flip
on through the depth (at a weight gain of 2, one flip at node 40 grew to
11 codes by node 66). The JAX package's own two modes differ the same
way. So each conv is also held on its own: given JAX's input codes, the
port's conv gives JAX's output codes to the kernels' bound (equal, or 1
apart on under 0.1 %).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pqdet_tpu.compress.qat import QuantCtx as JaxQuantCtx
from pqdet_tpu.compress.qat import prepare_qat_state as jax_prepare_qat_state
from pqdet_tpu.compress.quantized import Int8Inference as JaxInt8Inference
from pqdet_tpu.compress.quantized import convert_to_int8 as jax_convert_to_int8
from pqdet_tpu.config import default_config
from pqdet_tpu.evaluation.predict import build_predict_pipeline as jax_pipeline
from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
from pqdet_tpu.ops.boxes import iou as jax_iou
from pqdet_tpu.ops.postprocess import recover_bboxes as jax_recover
from pqdet_tpu.ops.preprocess import device_normalize as jax_normalize
from pqdet_tpu.zoo.mobilenetv2 import mobilenetv2_fpn
from pqdet_tpu_torch.bridge import from_jax_params, from_jax_qparams
from pqdet_tpu_torch.compress.qat import QuantCtx, prepare_qat_state
from pqdet_tpu_torch.compress.quantized import (Int8Inference, _quant_s8,
                                                _stem_im2col, convert_to_int8)
from pqdet_tpu_torch.config import Config
from pqdet_tpu_torch.evaluation.predict import (build_predict_pipeline,
                                                make_batch_predict)
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.ops.boxes import iou
from pqdet_tpu_torch.ops.postprocess import nms_batch, recover_bboxes
from pqdet_tpu_torch.ops.preprocess import device_normalize
from pqdet_tpu_torch.ops.qconv import make_scalars, qconv1x1_s8, qdwconv3x3_s8
from pqdet_tpu_torch.zoo import get_cfg

SIZE = 64
GAIN = 1.5
SHAPES = np.array([[375., 500.], [480., 360.]], np.float32)


def _images(seed):
    return np.random.RandomState(seed).randint(0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8)


def _calibrate():
    cfg = mobilenetv2_fpn(width_mult=0.25)
    assert cfg == get_cfg('mobilenetv2-fpn', width_mult=0.25)
    jnet = JaxNetwork.from_cfg(cfg, quant=True)
    params, state = jnet.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    params = {k: {**v, 'w': v['w'] * GAIN} for k, v in params.items()}
    for k in state:
        c = np.asarray(state[k]['mean']).shape[0]
        state[k] = {'mean': jnp.asarray(rng.randn(c).astype(np.float32) * 0.1),
                    'var': jnp.asarray(rng.rand(c).astype(np.float32) * 0.4 + 0.8)}
        params[k]['bn'] = {'gamma': jnp.asarray(rng.rand(c).astype(np.float32) * 0.4 + 0.8),
                           'beta': jnp.asarray(rng.randn(c).astype(np.float32) * 0.1)}
    params, state0 = jax_prepare_qat_state(jnet, params, state)

    @jax.jit
    def observer_pass(params, state, x):
        ctx = JaxQuantCtx(state['quant'], observing=True)
        jnet.apply(params, state, x, quant_ctx=ctx)
        return ctx.new_obs

    jstate = state0
    for seed in (1, 2):
        jstate = {**jstate, 'quant': observer_pass(params, jstate,
                                                   jax_normalize(jnp.asarray(_images(seed))))}
    qparams = jax_convert_to_int8(jnet, params, jstate)
    net = DetectionNetwork.from_cfg(get_cfg('mobilenetv2-fpn', width_mult=0.25), quant=True)
    return dict(jnet=jnet, params=params, state0=state0, jstate=jstate, qparams=qparams,
                net=net, qp=from_jax_qparams(qparams, net.graph, device='cpu'),
                x=np.array(jax_normalize(jnp.asarray(_images(3)))))


@pytest.fixture(scope='module')
def calibrated():
    return _calibrate()


@pytest.fixture(scope='module')
def jax_kernel_run(calibrated):
    """JAX pallas mode (Pallas kernels in interpret mode, dw_impl='pallas',
    static edge qparams as bench and trainer use them)."""
    jnet, qparams = calibrated['jnet'], calibrated['qparams']
    qpj = JaxInt8Inference.prepare(qparams, network=jnet)
    inf = JaxInt8Inference(jnet, mode='pallas', act=qpj['act'], dw_impl='pallas')
    preds, inter = jax.jit(lambda q, x: inf.apply(q, x, intermediates=True))(
        qpj, calibrated['x'])
    return np.asarray(preds), {k: np.asarray(v) for k, v in inter.items()}


@pytest.fixture(scope='module')
def jax_int_run(calibrated):
    jnet, qparams = calibrated['jnet'], calibrated['qparams']
    inf = JaxInt8Inference(jnet, mode='int', act=qparams['act'])
    preds, inter = jax.jit(lambda q, x: inf.apply(q, x, intermediates=True))(
        qparams, calibrated['x'])
    return np.asarray(preds), {k: np.asarray(v) for k, v in inter.items()}


def _port_run(calibrated, mode):
    inf = Int8Inference(calibrated['net'], mode=mode)
    qp = Int8Inference.prepare(calibrated['qp'], mode)
    with torch.inference_mode():
        preds, inter = inf.apply(qp, torch.from_numpy(calibrated['x']), intermediates=True)
    return preds.numpy(), {k: v.numpy() for k, v in inter.items()}


def _assert_preds_close(out, ref):
    assert out.shape == ref.shape == (2, (8 * 8 + 4 * 4 + 2 * 2) * 3, 25)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out[..., 4:], ref[..., 4:], atol=2e-2, rtol=0)
    np.testing.assert_allclose(out[..., :4], ref[..., :4], atol=0.5, rtol=0)


def test_kernel_mode_matches_jax_pallas(calibrated, jax_kernel_run):
    ref, jinter = jax_kernel_run
    out, inter = _port_run(calibrated, 'kernel')
    assert ref[..., 4:].max() - ref[..., 4:].min() > 0.1          # a spread of scores
    _assert_preds_close(out, ref)
    assert sorted(inter) == sorted(jinter)
    for k in jinter:
        assert inter[k].shape == jinter[k].shape, k


def test_int_mode_matches_jax_int(calibrated, jax_int_run):
    """The integer reference modes: the same arithmetic on both sides, up
    to XLA's FMA in the epilogue. Preds within 1e-4; every requantised
    node's codes equal or 1 apart on under 0.1 %; the f32 views of the
    heads within 1e-4 * max(1, |r|)."""
    ref, jinter = jax_int_run
    out, inter = _port_run(calibrated, 'int')
    _assert_preds_close(out, ref)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    assert sorted(inter) == sorted(jinter)
    act = calibrated['qparams']['act']
    for k, r in jinter.items():
        if k in act:
            d = np.round(np.abs(inter[k] - r) / act[k][0])
            assert d.max() <= 1 and (d > 0).mean() < 1e-3, k
        else:
            assert (np.abs(inter[k] - r) <= 1e-4 * np.maximum(1, np.abs(r))).all(), k


def _codes(view, sz):
    """Recentred s8 codes of a dequantised f32 view (exact inversion)."""
    return torch.from_numpy(np.round(view / sz[0] + (sz[1] - 128.0)).astype(np.int8))


def test_each_conv_matches_jax_on_jax_inputs(calibrated, jax_kernel_run):
    """Every conv of the kernel path, fed JAX's own input codes: s8 codes
    equal or 1 apart on under 0.1 %, f32 head outputs within 1e-5 *
    max(1, |r|)."""
    _, jinter = jax_kernel_run
    net, act = calibrated['net'], calibrated['qparams']['act']
    layers = Int8Inference.prepare(calibrated['qp'])['layers']
    n_conv = n_diff = n_all = 0
    for node in net.graph.nodes:
        if node.kind != 'convolutional':
            continue
        key, a = str(node.index), node.attrs
        p = layers[key]
        x_sz = act['input'] if node.index == 0 else act[str(node.index - 1)]
        x = (_quant_s8(torch.from_numpy(calibrated['x']), x_sz) if node.index == 0
             else _codes(jinter[str(node.index - 1)], x_sz))
        out_edge = act.get(key)
        kw = dict(act=a['activation'], requant=out_edge is not None,
                  scalars=make_scalars(*x_sz, *(out_edge or (None, None)), device='cpu'))
        if 'w2d' in p:
            y = qconv1x1_s8(x, p['w2d'], p['w_scale'], p['b'], p['colsum'], **kw)
        elif 'wdw' in p:
            y = qdwconv3x3_s8(x, p['wdw'], p['w_scale'], p['b'], stride=a['stride'], **kw)
        else:
            y = qconv1x1_s8(_stem_im2col(x, a['stride'], round(x_sz[1]) - 128), p['wim'],
                            p['w_scale'], p['b'], p['wim_colsum'], **kw)
        n_conv += 1
        if out_edge is None:
            ref = jinter[key]
            assert (np.abs(y.numpy() - ref) <= 1e-5 * np.maximum(1, np.abs(ref))).all(), key
            continue
        d = np.abs(y.numpy().astype(np.int32) - _codes(jinter[key], out_edge).numpy())
        assert d.max() <= 1, key
        n_diff, n_all = n_diff + int((d > 0).sum()), n_all + d.size
    assert n_conv == 84
    assert n_diff < 1e-3 * n_all, (n_diff, n_all)


def test_kernel_mode_plain_flag_and_launches(calibrated):
    """On the CPU, ``plain=True`` and the wrappers are the same functions;
    no kernel is launched."""
    inf = Int8Inference(calibrated['net'])
    qp = Int8Inference.prepare(calibrated['qp'])
    x = torch.from_numpy(calibrated['x'])
    before = (qconv1x1_s8.launches, qdwconv3x3_s8.launches)
    with torch.inference_mode():
        assert torch.equal(inf.apply(qp, x), inf.apply(qp, x, plain=True))
    assert (qconv1x1_s8.launches, qdwconv3x3_s8.launches) == before
    with pytest.raises(ValueError, match='mode'):
        Int8Inference(calibrated['net'], mode='pallas')


def test_kernel_mode_unadmitted_conv_matches_jax(calibrated):
    """At 62x62 the first stride-2 depthwise conv meets a 31x31 map, which
    neither int8 kernel takes (stride 2 needs even H and W): on the CPU both
    packages run that conv as the bf16 dequant conv, and the preds agree to
    the whole-net bounds."""
    jnet, qparams = calibrated['jnet'], calibrated['qparams']
    x = np.array(jax_normalize(jnp.asarray(_images(4)[:, :62, :62])))
    qpj = JaxInt8Inference.prepare(qparams, network=jnet)
    jinf = JaxInt8Inference(jnet, mode='pallas', act=qpj['act'], dw_impl='pallas')
    ref = np.asarray(jax.jit(jinf.apply)(qpj, x))
    inf = Int8Inference(calibrated['net'])
    qp = Int8Inference.prepare(calibrated['qp'])
    before = qdwconv3x3_s8.launches
    with torch.inference_mode():
        out = inf.apply(qp, torch.from_numpy(x)).numpy()
    assert qdwconv3x3_s8.launches == before
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out[..., 4:], ref[..., 4:], atol=2e-2, rtol=0)
    np.testing.assert_allclose(out[..., :4], ref[..., :4], atol=0.5, rtol=0)


def test_kernel_mode_unadmitted_conv_raises_off_cpu(calibrated):
    """Off the CPU the kernel path launches its kernels or raises: a 63x63
    input leaves the stride-2 stem with odd H and W, so the walk raises at
    the stem before any weight is read (a meta tensor stands in for the
    card). ``plain=True`` keeps the dequant conv on any device."""
    inf = Int8Inference(calibrated['net'])
    qp = Int8Inference.prepare(calibrated['qp'])
    x = torch.empty(2, 63, 63, 3, device='meta')
    with pytest.raises(ValueError, match='conv 0 .*fits neither int8 kernel'):
        inf.apply(qp, x)
    with torch.inference_mode():
        out = inf.apply(qp, torch.from_numpy(np.array(jax_normalize(
            jnp.asarray(_images(4)[:, :63, :63])))), plain=True)
    assert out.shape[0] == 2 and np.isfinite(out.numpy()).all()


def test_dequant_mode_matches_jax(calibrated):
    """Fake-quant edges and bf16 convs on both sides: bf16 rounds at other
    places in the two frameworks, so the bounds are the whole-net ones."""
    jnet, qparams = calibrated['jnet'], calibrated['qparams']
    ref = np.asarray(jax.jit(JaxInt8Inference(jnet, mode='dequant', act=qparams['act']).apply)(
        qparams, calibrated['x']))
    out, _ = _port_run(calibrated, 'dequant')
    _assert_preds_close(out, ref)


def test_calibration_matches_jax(calibrated):
    """The port's own observer passes (QuantCtx through Network.forward) on
    the carried weights and the same images. The walk is in f32 with a
    fake-quant round at every edge: a sum rounded in another order flips
    an element near a half step by one step, and the flip travels on, so
    later extremes move by a step or two (on these weights half the edges
    agree to 1e-5 and the largest gap is 2.2 steps at node 29). Bounds:
    the input edge and the stem's edge to rtol 1e-5; every observer's min
    and max within 3 quantisation steps of JAX's; so each edge scale within
    3 % and each zero point within 3."""
    jnet, net = calibrated['jnet'], calibrated['net']
    tp, ts = from_jax_params(calibrated['params'], calibrated['state0'], net.graph,
                             device='cpu')
    tp, ts = prepare_qat_state(net, tp, ts)
    with torch.inference_mode():
        for seed in (1, 2):
            ctx = QuantCtx(ts['quant'], observing=True)
            net(tp, ts, device_normalize(torch.from_numpy(_images(seed))), quant_ctx=ctx)
            ts = {**ts, 'quant': ctx.new_obs}
    jq = calibrated['jstate']['quant']
    jact = calibrated['qparams']['act']
    assert sorted(ts['quant']) == sorted(jq)
    for edge, obs in jq.items():
        for f in ('min', 'max'):
            got, want = float(ts['quant'][edge][f]), float(obs[f])
            if edge in ('input', '0'):
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
            assert abs(got - want) <= 3 * jact[edge][0] + 1e-6, (edge, f, got, want)
        assert bool(ts['quant'][edge]['initialized'])
    out = convert_to_int8(net, tp, ts)
    for edge, (s, zp) in jact.items():
        np.testing.assert_allclose(out['act'][edge][0], s, rtol=3e-2)
        assert abs(out['act'][edge][1] - zp) <= 3, edge


def _configs(thr, max_det):
    jcfg, cfg = default_config(), Config()
    for c in (jcfg, cfg):
        c.eval.input_size = SIZE
        c.eval.score_threshold = thr
        c.eval.max_detections = max_det
    return jcfg, cfg


def test_predict_pipeline_kernel_mode(calibrated):
    """build_predict_pipeline(apply_fn=Int8Inference.apply) through
    make_batch_predict gives the NMS of the kernel path's own preds."""
    net = calibrated['net']
    inf = Int8Inference(net)
    qp = Int8Inference.prepare(calibrated['qp'])
    _, cfg = _configs(0.3, 32)
    run = build_predict_pipeline(net, cfg, apply_fn=lambda p, im: inf.apply(p, im),
                                 device='cpu')
    dets = make_batch_predict(run, qp)({'image': _images(3), 'shape': SHAPES, 'count': 2})
    ev = cfg.eval
    with torch.inference_mode():
        preds = inf.apply(qp, device_normalize(torch.from_numpy(_images(3))))
        res = nms_batch(recover_bboxes(preds, torch.tensor([SIZE, SIZE], dtype=torch.float32),
                                       torch.from_numpy(SHAPES)),
                        ev.score_threshold, ev.iou_threshold, ev.max_detections,
                        ev.pool_factor, ev.nms_method, ev.nms_sigma)
    assert sum(len(d) for d in dets) > 0
    for i in range(2):
        keep = res.valid[i].numpy()
        ref = np.concatenate([res.boxes[i].numpy()[keep], res.scores[i].numpy()[keep, None],
                              res.classes[i].numpy()[keep, None]], 1)
        np.testing.assert_array_equal(dets[i], ref)
        assert np.isfinite(dets[i]).all()


def test_predict_pipeline_int_mode_matches_jax(calibrated):
    """Port and JAX pipelines with the int8 executor as ``apply_fn`` (int
    mode, the same arithmetic on both sides): the same detections. The
    three head convs get a gain of 10 on their scale and bias (f32 edges,
    so the codes stay as they are), which spreads the scores. The test
    first asserts that every NMS decision has a margin of 50 times the
    measured score and IoU error, so the comparison cannot flake on the
    last bits of the arithmetic."""
    jnet, net = calibrated['jnet'], calibrated['net']
    heads = {str(n.index - 1) for n in jnet.graph.yolo_nodes}
    qparams = {'act': calibrated['qparams']['act'], 'layers': {
        k: {**v, 'w_scale': v['w_scale'] * 10, 'b': v['b'] * 10} if k in heads else v
        for k, v in calibrated['qparams']['layers'].items()}}
    thr, max_det = 0.9, 32
    jcfg, cfg = _configs(thr, max_det)
    jinf = JaxInt8Inference(jnet, mode='int', act=qparams['act'])
    inf = Int8Inference(net, mode='int')
    qp = Int8Inference.prepare(from_jax_qparams(qparams, net.graph, device='cpu'), 'int')
    imgs = _images(3)
    in_size = np.array([SIZE, SIZE], np.float32)
    jrec = np.asarray(jax_recover(jax.jit(lambda q, x: jinf.apply(q, jax_normalize(x)))(
        qparams, jnp.asarray(imgs)), jnp.asarray(in_size), jnp.asarray(SHAPES)))
    with torch.inference_mode():
        trec = recover_bboxes(inf.apply(qp, device_normalize(torch.from_numpy(imgs))),
                              torch.from_numpy(in_size), torch.from_numpy(SHAPES)).numpy()
    score_err = max(np.abs(trec[..., 4:] - jrec[..., 4:]).max(), 1e-7)
    for i in range(2):
        sc = jrec[i, :, 4:]
        assert np.abs(sc - thr).min() > 50 * score_err
        cand = np.argwhere(sc > thr)
        s = np.sort(sc[sc > thr])
        assert 2 <= len(s) <= max_det and np.diff(s).min() > 50 * score_err
        b, c = jrec[i, cand[:, 0], :4], cand[:, 1]
        m = np.asarray(jax_iou(jnp.asarray(b[:, None]), jnp.asarray(b[None])))
        tb = torch.from_numpy(trec[i, cand[:, 0], :4])
        tm = iou(tb[:, None], tb[None]).numpy()
        same = (c[:, None] == c[None]) & ~np.eye(len(c), dtype=bool)
        if same.any():
            iou_err = max(np.abs(tm - m)[same].max(), 1e-6)
            assert np.abs(m[same] - 0.45).min() > 50 * iou_err

    jres = jax_pipeline(jnet, jcfg, apply_fn=jinf.apply)(qparams, jnp.asarray(imgs),
                                                         jnp.asarray(SHAPES))
    run = build_predict_pipeline(net, cfg, apply_fn=inf.apply, device='cpu')
    dets = make_batch_predict(run, qp)({'image': imgs, 'shape': SHAPES, 'count': 2})
    for i in range(2):
        keep = np.asarray(jres.valid[i])
        ref = np.concatenate([np.asarray(jres.boxes[i])[keep],
                              np.asarray(jres.scores[i])[keep, None],
                              np.asarray(jres.classes[i])[keep, None]], 1)
        assert dets[i].shape == ref.shape and len(ref) > 0
        np.testing.assert_array_equal(dets[i][:, 5], ref[:, 5])
        np.testing.assert_allclose(dets[i][:, :4], ref[:, :4], atol=1e-3)
        np.testing.assert_allclose(dets[i][:, 4], ref[:, 4], atol=1e-5)


def test_kernel_mode_yolo_intermediates_are_views_of_the_preds(calibrated, jax_kernel_run):
    """The heads are decoded once, after the walk, into the preds: each yolo
    node's intermediate is its (B, H, W, A, 5+C) view of them, with JAX's
    values for that node (the whole-net bounds)."""
    _, jinter = jax_kernel_run
    net = calibrated['net']
    inf = Int8Inference(net)
    qp = Int8Inference.prepare(calibrated['qp'])
    with torch.inference_mode():
        preds, inter = inf.apply(qp, torch.from_numpy(calibrated['x']), intermediates=True)
    heads = [inter[str(y.index)] for y in net.graph.yolo_nodes]
    assert [tuple(h.shape) for h in heads] == [(2, 2, 2, 3, 25), (2, 4, 4, 3, 25),
                                               (2, 8, 8, 3, 25)]
    assert all(h.untyped_storage().data_ptr() == preds.untyped_storage().data_ptr()
               for h in heads)
    assert torch.equal(torch.cat([h.reshape(2, -1, 25) for h in heads], 1), preds)
    for y, h in zip(net.graph.yolo_nodes, heads):
        ref = jinter[str(y.index)]
        np.testing.assert_allclose(h.numpy()[..., 4:], ref[..., 4:], atol=2e-2, rtol=0)
        np.testing.assert_allclose(h.numpy()[..., :4], ref[..., :4], atol=0.5, rtol=0)
