"""The ONNX exporters of the port (``pqdet_tpu_torch/exporters``) against
the JAX package's on the CPU: the protobuf writer, the fp and quantized
graphs byte for byte from the same weights, the port's torch evaluator
against JAX's numpy evaluator on the same files, and each round trip
against the port's own forward.

Weights: JAX's init of the cfgs of ``tests/test_prune.py`` and
``tests/test_onnx.py`` at 32 px, carried across with ``bridge``; the
quantized graph is calibrated by one JAX observer pass and converted by
JAX's ``convert_to_int8`` (and, for the port's own conversion, by the
port's on the bridged QAT state).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pqdet_tpu.compress.qat import QuantCtx as JaxQuantCtx
from pqdet_tpu.compress.qat import prepare_qat_state as jax_prepare_qat_state
from pqdet_tpu.compress.quantized import convert_to_int8 as jax_convert_to_int8
from pqdet_tpu.exporters import onnx_proto as JP
from pqdet_tpu.exporters.onnx_export import export_normal_to_onnx as jax_export_normal
from pqdet_tpu.exporters.onnx_export import export_quantized_to_onnx as jax_export_quant
from pqdet_tpu.exporters.onnx_runtime import run_model as jax_run_model
from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
from pqdet_tpu.model.network import densify_grouped_convs as jax_densify
from pqdet_tpu.model.network import fuse_params as jax_fuse_params
from pqdet_tpu_torch.bridge import from_jax_params, from_jax_qparams
from pqdet_tpu_torch.compress.quantized import Int8Inference, convert_to_int8
from pqdet_tpu_torch.exporters import onnx_proto as P
from pqdet_tpu_torch.exporters.onnx_export import (export_normal_to_onnx,
                                                   export_quantized_to_onnx)
from pqdet_tpu_torch.exporters.onnx_runtime import run_model
from pqdet_tpu_torch.model.factory import inference_params
from pqdet_tpu_torch.model.network import DetectionNetwork, fuse_params
from tests.test_onnx import _fpn_style_cfg, _regnet_style_cfg
from tests.test_prune import _mobile_style_cfg

SIZE = 32
CFGS = {'mobile': _mobile_style_cfg, 'fpn': _fpn_style_cfg}


def _nchw(x):
    return np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))


@pytest.fixture(scope='module', params=sorted(CFGS))
def fp_case(request):
    """(name, port net, JAX fused params, port fused from JAX's fused, port
    fold of JAX's unfused params, input)."""
    cfg = CFGS[request.param]()
    jnet = JaxNetwork.from_cfg(cfg)
    params, state = jnet.init(jax.random.PRNGKey(0))
    jfused = jax.tree.map(np.asarray, jax_fuse_params(jnet, params, state))
    net = DetectionNetwork.from_cfg(cfg)
    carried, _ = from_jax_params(jfused, {}, net.graph, device='cpu')
    folded = fuse_params(net, *from_jax_params(params, state, net.graph, device='cpu'))
    x = np.random.RandomState(0).rand(2, SIZE, SIZE, 3).astype(np.float32)
    return request.param, jnet, net, jfused, carried, folded, x


@pytest.fixture(scope='module')
def quant_case():
    """(JAX net, port net, JAX qparams, port qparams carried, port qparams
    of the port's own convert_to_int8, input)."""
    cfg = _mobile_style_cfg()
    jnet = JaxNetwork.from_cfg(cfg, quant=True)
    params, state = jnet.init(jax.random.PRNGKey(0))
    params, state = jax_prepare_qat_state(jnet, params, state)
    x = np.random.RandomState(1).rand(1, SIZE, SIZE, 3).astype(np.float32)
    ctx = JaxQuantCtx(state['quant'], observing=True)
    jnet.apply(params, state, jnp.asarray(x), quant_ctx=ctx)
    state = {**state, 'quant': ctx.new_obs}
    jq = jax_convert_to_int8(jnet, params, state)
    net = DetectionNetwork.from_cfg(cfg, quant=True)
    carried = from_jax_qparams(jax.tree.map(np.asarray, jq), net.graph, device='cpu')
    own = convert_to_int8(net, *from_jax_params(jax.tree.map(np.asarray, params),
                                                jax.tree.map(np.asarray, state),
                                                net.graph, device='cpu'))
    return jnet, net, jq, carried, own, x


def test_proto_roundtrip_and_bytes():
    """The port's writer and reader round-trip a model, and write the JAX
    writer's bytes for it."""
    def build(M):
        t = M.tensor('w', np.arange(12, dtype=np.float32).reshape(3, 4))
        n = M.node('Conv', ['x', 'w'], ['y'], strides=[2, 2], alpha=0.1, mode='nearest',
                   pads=[-1, 3])
        return M.model('g', [n], [M.value_info('x', M.FLOAT, [1, 3, None, 8])],
                       [M.value_info('y', M.FLOAT, [1, 4])], [t], doc='d')

    blob = P.encode_model(build(P))
    assert blob == JP.encode_model(build(JP))
    m2 = P.decode_model(blob)
    assert m2['opset'] == 13
    g = m2['graph']
    assert g['node'][0]['op_type'] == 'Conv'
    attrs = P.node_attrs(g['node'][0])
    assert attrs['strides'] == [2, 2] and attrs['pads'] == [-1, 3]
    assert abs(attrs['alpha'] - 0.1) < 1e-7
    assert attrs['mode'] == 'nearest'
    np.testing.assert_array_equal(P.tensor_to_numpy(g['initializer'][0]),
                                  np.arange(12, dtype=np.float32).reshape(3, 4))
    assert g['input'][0]['shape'] == [1, 3, None, 8]
    with pytest.raises(ValueError, match='undefined input'):
        P.check_model(P.model('g', [P.node('Relu', ['nope'], ['y'])], [], [], []))


def test_fp_onnx_bytes_equal_jax(fp_case):
    """The same BN-folded weights give the JAX writer's bytes, whether they
    cross folded or the port folds them (its fold is JAX's bit for bit)."""
    _, jnet, net, jfused, carried, folded, _ = fp_case
    want = jax_export_normal(jnet, jfused, (SIZE, SIZE), batch_size=2)
    assert export_normal_to_onnx(net, carried, (SIZE, SIZE), batch_size=2) == want
    assert export_normal_to_onnx(net, folded, (SIZE, SIZE), batch_size=2) == want


def test_quant_onnx_bytes_equal_jax(quant_case):
    jnet, net, jq, carried, own, _ = quant_case
    want = jax_export_quant(jnet, jq, (SIZE, SIZE), batch_size=1)
    assert export_quantized_to_onnx(net, carried, (SIZE, SIZE), batch_size=1) == want
    assert export_quantized_to_onnx(net, own, (SIZE, SIZE), batch_size=1) == want


def test_fp_runtime_matches_jax_numpy(fp_case):
    """The port's evaluator on JAX's file against JAX's numpy evaluator:
    1e-5 (the convs sum in float64 in both, in another order; exp and
    sigmoid are each library's f32)."""
    _, jnet, _, jfused, _, _, x = fp_case
    blob = jax_export_normal(jnet, jfused, (SIZE, SIZE), batch_size=2)
    want, = jax_run_model(blob, {'input': _nchw(x)})
    got, = run_model(blob, {'input': _nchw(x)}, device='cpu')
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_quant_runtime_matches_jax_numpy(quant_case):
    """On the quantized file the two evaluators give the same codes on
    every edge: QLinearConv's integer sum is exact in float64 in both and
    rounds to f32 at the same step. The outputs are held to 1e-5 x
    max(1, |v|), the room the decode's exp and sigmoid need; one code apart
    on any edge moves them by a quantization step (>= 1e-3 here) instead."""
    jnet, _, jq, _, _, x = quant_case
    blob = jax_export_quant(jnet, jq, (SIZE, SIZE), batch_size=1)
    want, = jax_run_model(blob, {'input': _nchw(x)})
    got, = run_model(blob, {'input': _nchw(x)}, device='cpu')
    got = got.numpy()
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= 1e-5 * np.maximum(1.0, np.abs(want)))


def test_fp_roundtrip_against_port_forward(fp_case):
    """The port's file, run by the port's evaluator, against the port's
    plain f32 walk: 1e-4, the tolerance of tests/test_onnx.py."""
    _, _, net, _, carried, _, x = fp_case
    with torch.inference_mode():
        ref = net(carried, {}, torch.from_numpy(x), plain=True).numpy()
    blob = export_normal_to_onnx(net, carried, (SIZE, SIZE), batch_size=2)
    out, = run_model(blob, {'input': _nchw(x)}, device='cpu')
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_quant_roundtrip_against_port_int8(quant_case):
    """The port's quantized file against ``Int8Inference(mode='int')``
    with the medians of tests/test_onnx.py: the int32 bias (QLinearConv's
    spec) adds up to half an output code per conv against the executor's
    f32 bias."""
    _, net, _, _, own, x = quant_case
    with torch.inference_mode():
        ref = Int8Inference(net, mode='int').apply(own, torch.from_numpy(x)).numpy()
    blob = export_quantized_to_onnx(net, own, (SIZE, SIZE), batch_size=1)
    out, = run_model(blob, {'input': _nchw(x)}, device='cpu')
    out = out.numpy()
    assert out.shape == ref.shape
    assert np.median(np.abs(out[..., :4] - ref[..., :4])) < 1.0
    assert np.median(np.abs(out[..., 4:] - ref[..., 4:])) < 0.05


@pytest.fixture(scope='module')
def grouped_quant_case():
    """``quant_case`` on the grouped cfg of tests/test_onnx.py (a group
    width 8 3x3): (JAX net, port net, JAX qparams, port qparams carried,
    input)."""
    cfg = _regnet_style_cfg()
    jnet = JaxNetwork.from_cfg(cfg, quant=True)
    params, state = jnet.init(jax.random.PRNGKey(0))
    params, state = jax_prepare_qat_state(jnet, params, state)
    x = np.random.RandomState(1).rand(1, SIZE, SIZE, 3).astype(np.float32)
    ctx = JaxQuantCtx(state['quant'], observing=True)
    jnet.apply(params, state, jnp.asarray(x), quant_ctx=ctx)
    jq = jax_convert_to_int8(jnet, params, {**state, 'quant': ctx.new_obs})
    net = DetectionNetwork.from_cfg(cfg, quant=True)
    carried = from_jax_qparams(jax.tree.map(np.asarray, jq), net.graph, device='cpu')
    return jnet, net, jq, carried, x


def test_grouped_quant_onnx_bytes_equal_jax(grouped_quant_case):
    """A grouped conv exports as one QLinearConv with group=G and its
    original grouped weights, the JAX writer's bytes."""
    jnet, net, jq, carried, _ = grouped_quant_case
    blob = export_quantized_to_onnx(net, carried, (SIZE, SIZE), batch_size=1)
    assert blob == jax_export_quant(jnet, jq, (SIZE, SIZE), batch_size=1)
    groups = [P.node_attrs(n)['group'] for n in P.decode_model(blob)['graph']['node']
              if n['op_type'] == 'QLinearConv']
    assert 4 in groups


def test_grouped_quant_roundtrip_against_port_int8(grouped_quant_case):
    """The grouped file run by the port's evaluator against
    ``Int8Inference(mode='int')`` (grouped convs) and its kernel mode
    (densified, plain on the CPU), with tests/test_onnx.py's medians."""
    _, net, _, carried, x = grouped_quant_case
    blob = export_quantized_to_onnx(net, carried, (SIZE, SIZE), batch_size=1)
    out = run_model(blob, {'input': _nchw(x)}, device='cpu')[0].numpy()
    for mode in ('int', 'kernel'):
        with torch.inference_mode():
            ref = Int8Inference(net, mode=mode).apply(
                Int8Inference.prepare(carried, mode, network=net), torch.from_numpy(x)).numpy()
        assert out.shape == ref.shape
        assert np.median(np.abs(out[..., :4] - ref[..., :4])) < 1.0, mode
        assert np.median(np.abs(out[..., 4:] - ref[..., 4:])) < 0.05, mode


@pytest.mark.parametrize('densify', [False, True])
def test_grouped_fp_onnx_bytes_equal_jax(densify):
    """The fp export of the grouped cfg from BN-folded weights, grouped or
    densified (``inference_params``' default; the group then comes from
    the weight's shape, 1): the JAX writer's bytes from JAX's same form."""
    cfg = _regnet_style_cfg()
    jnet = JaxNetwork.from_cfg(cfg)
    params, state = jnet.init(jax.random.PRNGKey(0))
    jfused = jax_fuse_params(jnet, params, state)
    if densify:
        jfused = jax_densify(jnet, jfused)
    jfused = jax.tree.map(np.asarray, jfused)
    net = DetectionNetwork.from_cfg(cfg)
    carried, _ = from_jax_params(jfused, {}, net.graph, device='cpu')
    want = jax_export_normal(jnet, jfused, (SIZE, SIZE), batch_size=2)
    assert export_normal_to_onnx(net, carried, (SIZE, SIZE), batch_size=2) == want
    if densify:
        port = inference_params(net, *from_jax_params(params, state, net.graph, device='cpu'))
        assert export_normal_to_onnx(net, port, (SIZE, SIZE), batch_size=2) == want
