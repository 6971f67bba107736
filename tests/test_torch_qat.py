"""QAT fake-quant, observers and int8 conversion of the port
(``pqdet_tpu_torch/compress``) against the JAX package on the same numpy
inputs. The port's conv weights are OIHW, the JAX package's HWIO: each
comparison transposes between them."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pqdet_tpu.compress.qat import act_qparams as jax_act_qparams
from pqdet_tpu.compress.qat import fake_quant_act as jax_fake_quant_act
from pqdet_tpu.compress.qat import fake_quant_weight as jax_fake_quant_weight
from pqdet_tpu.compress.qat import observe as jax_observe
from pqdet_tpu.compress.qat import prepare_qat_state as jax_prepare_qat_state
from pqdet_tpu.compress.quantized import convert_to_int8 as jax_convert_to_int8
from pqdet_tpu.compress.quantized import quantize_weights as jax_quantize_weights
from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
from pqdet_tpu.zoo.mobilenetv2 import mobilenetv2_fpn
from pqdet_tpu_torch.bridge import (from_jax_params, from_jax_quant_state,
                                    hwio_to_oihw)
from pqdet_tpu_torch.compress.qat import (QuantCtx, act_qparams, fake_quant_act,
                                          fake_quant_weight, observe,
                                          prepare_qat_state)
from pqdet_tpu_torch.compress.quantized import convert_to_int8, quantize_weights
from pqdet_tpu_torch.model.network import DetectionNetwork


def _obs(mn, mx, init):
    return {'min': np.float32(mn), 'max': np.float32(mx), 'initialized': np.bool_(init)}


def _t_obs(o):
    return {'min': torch.tensor(o['min']), 'max': torch.tensor(o['max']),
            'initialized': torch.tensor(bool(o['initialized']))}


def _j_obs(o):
    return {k: jnp.asarray(v) for k, v in o.items()}


@pytest.mark.parametrize('init', [False, True])
def test_observe_matches_jax(init):
    x = np.random.RandomState(0).randn(2, 5, 5, 3).astype(np.float32) * 3 + 0.5
    o = _obs(-0.7, 4.2, init)
    ref = jax_observe(_j_obs(o), jnp.asarray(x), True)
    out = observe(_t_obs(o), torch.from_numpy(x))
    for k in ('min', 'max'):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=1e-6, atol=1e-6)
    assert bool(out['initialized']) and bool(ref['initialized'])


@pytest.mark.parametrize('mn,mx', [(0.0, 6.0), (-1.0, 3.0), (-2.5, -0.5), (0.3, 0.3),
                                   (-0.011, 17.3)])
def test_act_qparams_and_fake_quant_act_match_jax(mn, mx):
    o = _obs(mn, mx, True)
    js, jzp = jax_act_qparams(_j_obs(o))
    s, zp = act_qparams(_t_obs(o))
    np.testing.assert_allclose(float(s), float(js), rtol=1e-6)
    assert float(zp) == float(jzp)
    x = np.linspace(mn - 1, mx + 1, 301, dtype=np.float32)
    ref = np.asarray(jax_fake_quant_act(jnp.asarray(x), _j_obs(o)))
    out = fake_quant_act(torch.from_numpy(x), _t_obs(o)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('shape', [(3, 3, 8, 16), (1, 1, 24, 40), (3, 3, 1, 32)])
def test_fake_quant_weight_matches_jax(shape):
    """Per-output-channel scales: the port reduces OIHW over dims 1-3, JAX
    reduces HWIO over dims 0-2."""
    w = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    w[..., 0] *= 1e-3                      # a channel with a tiny range
    ref = np.asarray(jax_fake_quant_weight(jnp.asarray(w)))
    out = fake_quant_weight(torch.from_numpy(hwio_to_oihw(w))).numpy()
    np.testing.assert_allclose(out, hwio_to_oihw(ref), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('shape', [(1, 1, 4, 16), (3, 3, 16, 32)])
def test_fake_quant_weight_ste_gradient_matches_jax(shape):
    """Straight-through, with JAX's clip gradient: an output channel's
    largest |w| most often lands exactly on +-127, where ``jnp.clip`` passes
    0.5 (a tie with the bound); the port's gradient equals JAX's exactly."""
    w = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    cot = np.random.RandomState(1).rand(*shape).astype(np.float32)
    g_ref = np.asarray(jax.grad(lambda x: jnp.sum(jax_fake_quant_weight(x) * cot))(
        jnp.asarray(w)))
    tw = torch.from_numpy(hwio_to_oihw(w)).requires_grad_(True)
    (fake_quant_weight(tw) * torch.from_numpy(hwio_to_oihw(cot))).sum().backward()
    g = hwio_to_oihw(g_ref)
    ties = np.isclose(g, 0.5 * hwio_to_oihw(cot), rtol=0, atol=0)
    assert ties.sum() >= shape[-1] // 2             # ties in most output channels
    np.testing.assert_array_equal(tw.grad.numpy(), g)


def test_fake_quant_act_ste_gradient_matches_jax():
    """The activation clip at codes 0 and 255: JAX's gradient 0.5 where the
    rounded code ties with a bound (-0.5 rounds to code 0), 1 inside and 0
    outside, equal exactly."""
    o = _obs(-1.0, 254.0, True)                     # scale 1, zero point 1
    x = np.array([-3.0, -1.0, -0.5, 0.0, 100.0, 254.0, 300.0], np.float32)
    g_ref = np.asarray(jax.grad(lambda v: jnp.sum(jax_fake_quant_act(v, _j_obs(o))))(
        jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_(True)
    fake_quant_act(tx, _t_obs(o)).sum().backward()
    assert list(g_ref) == [0.0, 0.5, 0.5, 1.0, 1.0, 0.5, 0.0]
    np.testing.assert_array_equal(tx.grad.numpy(), g_ref)


def test_fake_quant_act_of_bf16_is_f32_as_jax():
    """A bf16 activation fake-quantises in f32 and comes back f32, as JAX's
    promotion against the observer's f32 scale gives: the same values as
    JAX on the same bf16 input (in bf16 the codes of 128-255 would lie only
    1 apart and round elsewhere)."""
    o = _obs(-0.4, 9.7, True)
    x = (np.random.RandomState(2).randn(4, 8, 8, 16) * 4).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = jax_fake_quant_act(xb, _j_obs(o))
    out = fake_quant_act(torch.from_numpy(np.asarray(xb.astype(jnp.float32))).bfloat16(),
                         _t_obs(o))
    assert ref.dtype == jnp.float32 and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_quantize_weights_matches_jax():
    w = np.random.RandomState(3).randn(3, 3, 16, 24).astype(np.float32) * 0.1
    jq, js = jax_quantize_weights(w)
    q, s = quantize_weights(torch.from_numpy(hwio_to_oihw(w)))
    np.testing.assert_allclose(s.numpy(), js, rtol=1e-6)
    diff = np.abs(q.numpy().astype(np.int32) - hwio_to_oihw(jq).astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


def _quant_model():
    """The quant graph of mobilenetv2-fpn at width 0.25 on both sides, JAX
    weights with seeded BN statistics and seeded observers (as after a
    calibration), carried across."""
    cfg = mobilenetv2_fpn(width_mult=0.25)
    jnet = JaxNetwork.from_cfg(cfg, quant=True)
    params, state = jnet.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    for k in state:
        c = np.asarray(state[k]['mean']).shape[0]
        state[k] = {'mean': jnp.asarray(rng.randn(c).astype(np.float32) * 0.1),
                    'var': jnp.asarray(rng.rand(c).astype(np.float32) * 0.4 + 0.8)}
    params, state = jax_prepare_qat_state(jnet, params, state)
    quant = {}
    for edge in state['quant']:
        mn = -abs(rng.randn()) * (edge == 'input' or rng.rand() < 0.2)
        quant[edge] = {'min': jnp.float32(mn), 'max': jnp.float32(abs(rng.randn()) * 4 + 0.1),
                       'initialized': jnp.bool_(True)}
    state = {**state, 'quant': quant}
    net = DetectionNetwork.from_cfg(cfg, quant=True)
    tp, ts = from_jax_params(params, state, net.graph, device='cpu')
    ts['quant'] = from_jax_quant_state(state, device='cpu')
    return jnet, params, state, net, tp, ts


def test_prepare_qat_state_matches_jax():
    jnet, params, state, net, tp, ts = _quant_model()
    _, st = prepare_qat_state(net, tp, {k: v for k, v in ts.items() if k != 'quant'})
    assert sorted(st['quant']) == sorted(state['quant'])
    assert str(jnet.graph.yolo_nodes[0].index - 1) not in st['quant']
    for obs in st['quant'].values():
        assert obs['min'].device.type == 'cpu' and not bool(obs['initialized'])
    assert all(n.attrs['activation'] in ('relu', 'linear')
               for n in net.graph.nodes if n.kind == 'convolutional')


def test_quant_ctx_hooks():
    """QuantCtx fake-quantises only the observed edges and collects the new
    observers; fake_weights is the per-channel weight fake-quant."""
    o = _t_obs(_obs(-1.0, 3.0, True))
    ctx = QuantCtx({'input': o, '0': o}, observing=True)
    x = torch.linspace(-2, 4, 50)
    assert torch.equal(ctx.observe_output('7', x), x)          # no observer
    y = ctx.quantize_input(x)
    new = ctx.new_obs['input']
    assert float(new['min']) < -1.0 and float(new['max']) > 3.0   # moved toward x's range
    assert torch.equal(y, fake_quant_act(x, new))
    w = torch.randn(4, 3, 3, 3)
    assert torch.equal(ctx.fake_weights('0', w), fake_quant_weight(w))
    frozen = QuantCtx({'input': o}, observing=False)
    frozen.quantize_input(x)
    assert frozen.new_obs['input'] is o


def test_convert_to_int8_matches_jax():
    """On carried weights and observers: wq equal or 1 code apart on under
    0.1 %, w_scale and b rtol 1e-5, edge scales rtol 1e-6, zero points
    equal."""
    jnet, params, state, net, tp, ts = _quant_model()
    ref = jax_convert_to_int8(jnet, params, state)
    out = convert_to_int8(net, tp, ts)
    assert sorted(out['layers']) == sorted(ref['layers'])
    n_diff = n_all = 0
    for k, r in ref['layers'].items():
        o = out['layers'][k]
        assert o['wq'].dtype == torch.int8
        d = np.abs(o['wq'].numpy().astype(np.int32) - hwio_to_oihw(r['wq']).astype(np.int32))
        assert d.max() <= 1
        n_diff, n_all = n_diff + int((d > 0).sum()), n_all + d.size
        np.testing.assert_allclose(o['w_scale'].numpy(), r['w_scale'], rtol=1e-5)
        np.testing.assert_allclose(o['b'].numpy(), r['b'], rtol=1e-5, atol=1e-6)
    assert n_diff < 1e-3 * n_all
    assert sorted(out['act']) == sorted(ref['act'])
    for edge, (s, zp) in ref['act'].items():
        np.testing.assert_allclose(out['act'][edge][0], s, rtol=1e-6)
        assert out['act'][edge][1] == zp
    with pytest.raises(ValueError, match='quant observers'):
        convert_to_int8(net, tp, {k: v for k, v in ts.items() if k != 'quant'})
