"""The int8 serving slice's kernel mode against JAX's ``pallas`` mode: the
cases of ``tests/test_torch_int8.py`` that read JAX's Pallas kernels (in
interpret mode) or its pallas-mode walk at another input size, in a file
of their own so that the two halves of the slice run on two workers.

The model, its calibration, and the bounds and why they are JAX's own are
``tests/test_torch_int8.py``'s (its module docstring): the whole-net preds
to scores 2e-2 and boxes 0.5 px, each conv on JAX's input codes equal or
1 apart on under 0.1 %.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pqdet_tpu.compress.quantized import Int8Inference as JaxInt8Inference
from pqdet_tpu.ops.preprocess import device_normalize as jax_normalize
from pqdet_tpu_torch.compress.quantized import Int8Inference, _stem_im2col
from pqdet_tpu_torch.ops.qconv import make_scalars, qconv1x1_s8, qdwconv3x3_s8, quant_s8
from test_torch_int8 import _assert_preds_close, _calibrate, _images, _port_run


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small CPU ops: beside the
    suite's other workers, an op split over all cores waits at its barrier
    for threads those workers hold (a 64 px int8 walk of
    ``test_kernel_mode_plain_flag_and_launches`` took 0.2 s alone and 35 s
    beside five busy processes, 0.8 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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



def test_kernel_mode_matches_jax_pallas(calibrated, jax_kernel_run):
    ref, jinter = jax_kernel_run
    out, inter = _port_run(calibrated, 'kernel')
    assert ref[..., 4:].max() - ref[..., 4:].min() > 0.1          # a spread of scores
    _assert_preds_close(out, ref)
    assert sorted(inter) == sorted(jinter)
    for k in jinter:
        assert inter[k].shape == jinter[k].shape, k


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
        x = (quant_s8(torch.from_numpy(calibrated['x']), x_sz[0], x_sz[1] - 128.0)
             if node.index == 0 else _codes(jinter[str(node.index - 1)], x_sz))
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
