"""The port's space-to-depth stem against the JAX package's, on the CPU: the
fold (numpy and torch) at both of JAX's shapes, mobilenetv2-fpn at 64 px
with ``s2d_stem`` 2 and -2 against JAX's ``apply(..., s2d_stem=2)`` in f32,
the grad of the original stem kernel, the walks that combine it (remat
segments, the fused-IR table), the errors, and the predict pipeline with
``eval.s2d_stem``."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from pqdet_tpu.config import load_config as jax_load_config
from pqdet_tpu.evaluation.predict import build_predict_pipeline as jax_pipeline
from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
from pqdet_tpu.model.network import fuse_params as jax_fuse_params
from pqdet_tpu.ops.space_to_depth import fold_stem_weight as jax_fold
from pqdet_tpu.ops.space_to_depth import space_to_depth as jax_s2d
from pqdet_tpu.zoo import get_cfg as jax_get_cfg
from pqdet_tpu_torch.bridge import from_jax_params
from pqdet_tpu_torch.compress.qat import QuantCtx, prepare_qat_state
from pqdet_tpu_torch.config import load_config
from pqdet_tpu_torch.evaluation.predict import build_predict_pipeline, make_batch_predict
from pqdet_tpu_torch.model.network import DetectionNetwork, Network, fuse_params
from pqdet_tpu_torch.ops.fused_ir import prepare_fused_ir
from pqdet_tpu_torch.ops.space_to_depth import (fold_stem_weight, fold_stem_weight_t,
                                                space_to_depth, stem_foldable)
from pqdet_tpu_torch.train.step import train_step_from_config
from test_torch_network import SHAPES as NET_SHAPES
from test_torch_network import SIZE
from test_torch_network import _images as net_images
from test_torch_network import _model as net_model


@pytest.mark.parametrize('hw,k,stride,pad', [(16, 3, 2, 1), (16, 2, 2, 0)])
def test_fold_parity(hw, k, stride, pad):
    """JAX's two shapes (the zoo stem; an even kernel with valid padding):
    the port's numpy fold is JAX's kernel bit for bit, the torch fold is the
    same kernel in OIHW, and the folded conv on the s2d input equals the
    stem conv (1e-5, as tests/test_s2d.py)."""
    rng = np.random.RandomState(0)
    x = rng.randn(2, hw, hw, 3).astype(np.float32)
    w = rng.randn(k, k, 3, 8).astype(np.float32)
    want, jph, jpw = jax_fold(w, stride, stride, pad)
    wf, ph, pw = fold_stem_weight(w, stride, stride, pad)
    np.testing.assert_array_equal(wf, want)
    assert (ph, pw) == (jph, jpw)
    wt, pht, pwt = fold_stem_weight_t(torch.from_numpy(w).permute(3, 2, 0, 1), stride,
                                      stride, pad)
    np.testing.assert_array_equal(wt.numpy(), wf.transpose(3, 2, 0, 1))
    assert (pht, pwt) == (ph, pw)
    np.testing.assert_array_equal(space_to_depth(torch.from_numpy(x), stride).numpy(),
                                  np.asarray(jax_s2d(jnp.asarray(x), stride)))

    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    ref = F.conv2d(xt, torch.from_numpy(w).permute(3, 2, 0, 1), stride=stride, padding=pad)
    xs = space_to_depth(torch.from_numpy(x), stride)
    xs = F.pad(xs, (0, 0, pw[0], pw[1], ph[0], ph[1])).permute(0, 3, 1, 2)
    np.testing.assert_allclose(F.conv2d(xs, wt).numpy(), ref.numpy(), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope='module')
def model():
    cfg = jax_get_cfg('mobilenetv2-fpn', num_classes=3)
    jnet = JaxNetwork.from_cfg(cfg)
    params, state = jnet.init(jax.random.PRNGKey(0))
    net = DetectionNetwork.from_cfg(cfg)
    tp, ts = from_jax_params(params, state, net.graph, device='cpu')
    x = np.random.RandomState(1).rand(2, SIZE, SIZE, 3).astype(np.float32)
    return jnet, params, state, net, tp, ts, x


@pytest.fixture(scope='module')
def jax_s2d_preds(model):
    jnet, params, state, *_, x = model
    fused = jax_fuse_params(jnet, params, state)
    out, _ = jax.jit(lambda p, x: jnet.apply(p, {}, x, s2d_stem=2))(fused, jnp.asarray(x))
    return np.asarray(out)


@pytest.mark.parametrize('s2d', [2, -2])
def test_forward_matches_jax(model, jax_s2d_preds, s2d):
    """f32 mobilenetv2-fpn at 64 px on JAX's weights: the port's walk with
    s2d_stem 2 (reshaped here) and -2 (the caller ships the s2d layout)
    against JAX's apply(..., s2d_stem=2) (1e-4, as tests/test_s2d.py), and
    against the port's own unfolded walk."""
    _, _, _, net, tp, ts, x = model
    fused = fuse_params(net, tp, ts)
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        out = net(fused, {}, space_to_depth(xt, 2) if s2d < 0 else xt, s2d_stem=s2d).numpy()
        ref = net(fused, {}, xt).numpy()
    assert out.shape == jax_s2d_preds.shape == (2, (8 * 8 + 4 * 4 + 2 * 2) * 3, 8)
    np.testing.assert_allclose(out, jax_s2d_preds, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)


def test_stem_grad_matches_jax(model):
    """The loss's grad on the ORIGINAL stem kernel through the differentiable
    fold, against JAX's (rtol 1e-4, atol 1e-6, as tests/test_s2d.py) and the
    port's unfolded walk's."""
    jnet, params, state, net, tp, ts, x = model

    def jloss(p):
        preds, _ = jnet.apply(p, state, jnp.asarray(x), train=False, s2d_stem=2)
        return jnp.sum(preds.astype(jnp.float32) ** 2) * 1e-6

    want = np.asarray(jax.jit(jax.grad(jloss))(params)['0']['w']).transpose(3, 2, 0, 1)

    def grad(s2d):
        w = tp['0']['w'].detach().clone().requires_grad_(True)
        p = {**tp, '0': {**tp['0'], 'w': w}}
        preds, _ = net.forward_train(p, ts, torch.from_numpy(x), train=False, s2d_stem=s2d)
        (torch.sum(preds.float() ** 2) * 1e-6).backward()
        return w.grad.numpy()

    got = grad(2)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got, grad(0), rtol=1e-4, atol=1e-6)


def test_s2d_combines_with_remat_and_fused_ir(model):
    """Node 0 lies in remat segment 0, so a segmented train walk folds it
    as the plain one does; the fused-IR table leaves the stem to the walk."""
    _, _, _, net, tp, ts, x = model
    xt = torch.from_numpy(x)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        a, sa = net.forward_train(tp, ts, xt, rng=gen, s2d_stem=2)
        b, sb = net.forward_train(tp, ts, xt, rng=gen, s2d_stem=2, remat_segments=3)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    for k in ts:
        for name in ts[k]:
            np.testing.assert_array_equal(sa[k][name].numpy(), sb[k][name].numpy())
    fused = fuse_params(net, tp, ts)
    table = prepare_fused_ir(net, fused)
    assert 0 not in table and len(table) == 21
    with torch.inference_mode():
        got = net(fused, {}, xt, fused_ir=table, s2d_stem=2)
        ref = net(fused, {}, xt, fused_ir=table)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-4)


UNFOLDABLE = '''[net]
channels=3
[convolutional]
filters=8
size=3
pad=1
stride=1
batch_normalize=1
activation=leaky
'''


@pytest.mark.parametrize('case', ['quant_ctx', 'stride_1_stem', 'stride_4_request'])
def test_s2d_errors(model, case):
    """ValueError with a quant_ctx (the stem observer would see folded
    weights), for a stem at stride 1, and for a factor other than the stem's
    stride; stem_foldable names the zoo stem."""
    _, _, _, net, tp, ts, x = model
    xt = torch.from_numpy(x)
    assert stem_foldable(net.graph.nodes[0])
    if case == 'quant_ctx':
        _, qs = prepare_qat_state(net, tp, ts)
        with pytest.raises(ValueError, match='quant_ctx'):
            net.forward_train(tp, qs, xt, quant_ctx=QuantCtx(qs['quant']), s2d_stem=2)
    elif case == 'stride_1_stem':
        small = Network.from_cfg(UNFOLDABLE)
        assert not stem_foldable(small.graph.nodes[0])
        p, s = small.init(torch.Generator().manual_seed(0), device='cpu')
        with pytest.raises(ValueError, match='stride-2 stem conv as node 0'):
            small(p, s, xt, s2d_stem=2)
    else:
        with pytest.raises(ValueError, match='stride-4 stem conv as node 0'):
            net(tp, ts, xt, s2d_stem=4)


def test_batch_predict_matches_jax():
    """make_batch_predict of a pipeline built with eval.s2d_stem 2 against
    JAX's pipeline with the same config, on test_torch_network's weights,
    images and threshold (where that test shows every NMS decision has a
    wide margin): the same detections (classes equal, boxes and scores
    close), and the same as the port's unfolded pipeline."""
    jnet, params, state, net, tp, ts = net_model(2, head_gain=30.0)
    opts = ['dataset.classes', '[a, b]', 'eval.input_size', str(SIZE),
            'eval.score_threshold', '0.85', 'eval.max_detections', '32', 'eval.s2d_stem', '2']
    images, shapes = net_images(), NET_SHAPES
    jres = jax.device_get(jax_pipeline(jnet, jax_load_config(opts=opts))(
        jax_fuse_params(jnet, params, state), jnp.asarray(images), jnp.asarray(shapes)))
    assert not np.asarray(jres.overflow).any()
    fused = fuse_params(net, tp, ts)
    batch = {'image': images, 'shape': shapes, 'count': 2}
    got = make_batch_predict(build_predict_pipeline(net, load_config(opts=opts),
                                                    device='cpu'), fused)(batch)
    cfg0 = load_config(opts=opts[:-2])
    assert cfg0.eval.s2d_stem == 0
    plain = make_batch_predict(build_predict_pipeline(net, cfg0, device='cpu'), fused)(batch)
    for i in range(2):
        keep = np.asarray(jres.valid[i])
        ref = np.concatenate([np.asarray(jres.boxes[i])[keep],
                              np.asarray(jres.scores[i])[keep, None],
                              np.asarray(jres.classes[i])[keep, None]], 1)
        assert got[i].shape == ref.shape == plain[i].shape and len(ref) > 0
        for other in (ref, plain[i]):
            np.testing.assert_array_equal(got[i][:, 5], other[:, 5])
            np.testing.assert_allclose(got[i][:, :4], other[:, :4],
                                       atol=1e-3 * np.abs(other[:, :4]).max())
            np.testing.assert_allclose(got[i][:, 4], other[:, 4], atol=1e-5)


def test_train_step_reads_s2d_stem(model, monkeypatch):
    """train_step_from_config with train.s2d_stem 2 runs the train walk with
    the folded stem, and one f32 step from the same params and batch as
    s2d_stem 0 gives a loss within 1e-3: the walk with batch statistics is
    badly conditioned at init (tests/test_torch_train_parity.py), so the
    fold's last-bit changes move the loss by ~1e-4 of itself."""
    _, _, _, net, tp, ts, _ = model
    seen = []
    walk = net.forward_train

    def spy(*args, **kwargs):
        seen.append(kwargs.get('s2d_stem'))
        return walk(*args, **kwargs)

    monkeypatch.setattr(net, 'forward_train', spy)
    rng = np.random.RandomState(3)
    gt = np.zeros((2, 8, 6), np.float32)
    gt[:, :2] = [[8, 8, 40, 30, 1, 1], [20, 16, 60, 60, 2, 1]]
    batch = {'image': torch.from_numpy(rng.randint(0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8)),
             'gt': torch.from_numpy(gt)}
    out = {}
    for s2d in (0, 2):
        cfg = load_config(opts=['dataset.classes', '[a, b, c]', 'system.compute_dtype',
                                'float32', 'model.max_gt_boxes', '8', 'train.s2d_stem', str(s2d)])
        step, opt = train_step_from_config(net, cfg, 4, device='cpu')
        p, _, _, m = step(tp, ts, opt.init(tp), batch)
        out[s2d] = m['loss'].item()
        assert bool(torch.isfinite(p['0']['w']).all())
    assert seen == [0, 2]
    np.testing.assert_allclose(out[2], out[0], rtol=1e-3)
