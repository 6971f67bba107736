"""Int8 serving of grouped convs (the RegNet pattern), pqdet_tpu_torch
against the JAX package on the CPU: ``Int8Inference.prepare(network=)``
densifies grouped weights as JAX's does; the port's kernel mode (the
kernels' plain versions on the CPU) against JAX's ``pallas`` mode (its
Pallas kernels in interpret mode) and JAX's ``int`` oracle, which runs the
original grouped convs; and conv by conv against the port's own integer
mode.

Two graphs: the grouped net of ``tests/test_qat.py`` at 32 px (grouped 3x3s
of group width 4 at stride 2, densified through im2col; a grouped 1x1) and
regnety-400m-fpn at 64 px, B=2 (grouped 3x3s at Cin 48-440 of group width
8 and 16, stride 1 and 2, through ``qgconv3x3_s8`` on the compact weights;
squeeze-excite 1x1s at M = B; strided 1x1 projections). Weights:
JAX's init with every conv weight times GAIN and seeded BN statistics, two
observer passes under ``jax.jit``, JAX's ``convert_to_int8``, carried by
``bridge.from_jax_qparams``.

The whole-walk bounds are JAX's own (scores 2e-2, boxes 0.5 px,
tests/test_qat.py): the two packages round the epilogue apart (XLA on the
CPU contracts it into an FMA), and JAX's ``pallas`` mode runs the strided
1x1 projections as its bf16 dequant conv where the port runs them exactly
through the 1x1 kernel. Conv by conv, the kernel mode is held to the
integer mode with the gate ``chip_smoke.py`` holds the two to (codes equal
or 1 apart on under 1e-5 of them).
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import chip_smoke
from pqdet_tpu.compress.qat import QuantCtx as JaxQuantCtx
from pqdet_tpu.compress.qat import prepare_qat_state as jax_prepare_qat_state
from pqdet_tpu.compress.quantized import Int8Inference as JaxInt8Inference
from pqdet_tpu.compress.quantized import convert_to_int8 as jax_convert_to_int8
from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
from pqdet_tpu_torch.bridge import from_jax_qparams, hwio_to_oihw
from pqdet_tpu_torch.compress.quantized import Int8Inference, im2col_depth
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.ops.qconv import qconv1x1_s8, qdwconv3x3_s8
from pqdet_tpu_torch.zoo import get_cfg
from tests.test_qat import _grouped_cfg

GAIN = 1.5
CASES = {'grouped': (_grouped_cfg, 32),
         'regnety-400m-fpn': (lambda: get_cfg('regnety-400m-fpn'), 64)}


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


@functools.lru_cache(maxsize=None)
def _calibrate(name):
    cfg_fn, size = CASES[name]
    cfg = cfg_fn()
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
    params, state = jax_prepare_qat_state(jnet, params, state)

    @jax.jit
    def observer_pass(params, state, x):
        ctx = JaxQuantCtx(state['quant'], observing=True)
        jnet.apply(params, state, x, quant_ctx=ctx)
        return ctx.new_obs

    def images(seed):
        return np.random.RandomState(seed).rand(2, size, size, 3).astype(np.float32) * 2 - 1

    for seed in (1, 2):
        state = {**state, 'quant': observer_pass(params, state, jnp.asarray(images(seed)))}
    qparams = jax.tree.map(np.asarray, jax_convert_to_int8(jnet, params, state))
    net = DetectionNetwork.from_cfg(cfg, quant=True)
    return dict(name=name, jnet=jnet, qparams=qparams, net=net, size=size,
                qp=from_jax_qparams(qparams, net.graph, device='cpu'), x=images(3))


@pytest.fixture(scope='module', params=sorted(CASES))
def calibrated(request):
    return _calibrate(request.param)


@pytest.fixture(scope='module')
def runs(calibrated):
    """Preds of JAX's pallas mode (prepare(network=), static edge qparams,
    the Pallas kernels in interpret mode), JAX's int oracle, and the port's
    kernel and int modes."""
    jnet, qparams, x = calibrated['jnet'], calibrated['qparams'], calibrated['x']
    qpj = JaxInt8Inference.prepare(qparams, network=jnet)
    pallas = JaxInt8Inference(jnet, mode='pallas', act=qpj['act'], dw_impl='pallas')
    oracle = JaxInt8Inference(jnet, mode='int', act=qparams['act'])
    out = {'pallas': np.asarray(jax.jit(pallas.apply)(qpj, x)),
           'oracle': np.asarray(jax.jit(oracle.apply)(qparams, x))}
    net, qp = calibrated['net'], calibrated['qp']
    with torch.inference_mode():
        for mode in ('kernel', 'int'):
            staged = Int8Inference.prepare(qp, mode, network=net)
            out[mode] = Int8Inference(net, mode=mode).apply(staged, torch.from_numpy(x)).numpy()
    return out


def test_prepare_densifies_grouped_convs_like_jax():
    """``prepare(network=)`` densifies the grouped 3x3s into im2col weights
    (``wim``, equal to JAX's, which stages the same (kh, kw, cin) rows at
    these widths) and the grouped 1x1 into ``w2d`` (JAX's); ``wq`` stays
    grouped; without ``network`` a grouped conv's views are of its compact
    weights, whose depth the walk admits for no input (as in JAX)."""
    c = _calibrate('grouped')
    jq = JaxInt8Inference.prepare(c['qparams'], network=c['jnet'])['layers']
    layers = Int8Inference.prepare(c['qp'], network=c['net'])['layers']
    assert layers['1']['wim'].shape == (im2col_depth(16), 32) == (144, 32)
    assert layers['2']['w2d'].shape == (32, 32)
    assert layers['3']['wim'].shape == (im2col_depth(32), 48) == (288, 48)
    for key, view in (('1', 'wim'), ('2', 'w2d'), ('3', 'wim')):
        np.testing.assert_array_equal(layers[key][view].numpy(), np.asarray(jq[key][view]))
        np.testing.assert_array_equal(layers[key][view.replace('w2d', 'colsum').replace(
            'wim', 'wim_colsum')].numpy(), np.asarray(jq[key][
                'colsum' if view == 'w2d' else 'wim_colsum']))
    assert layers['1']['wq'].shape == (32, 4, 3, 3)
    np.testing.assert_array_equal(layers['1']['wq'].numpy(),
                                  hwio_to_oihw(c['qparams']['layers']['1']['wq']))
    bare = Int8Inference.prepare(c['qp'])['layers']     # compact weights, as JAX stages them
    assert bare['1']['wim'].shape[0] == im2col_depth(4) != im2col_depth(16)
    assert bare['2']['w2d'].shape[0] == 4 != 32


def _zero_qparams(net):
    """int8 qparams of zeros for every conv of ``net`` (the views'
    shapes only)."""
    layers = {}
    for node in net.graph.nodes:
        if node.kind == 'convolutional':
            a = node.attrs
            layers[str(node.index)] = {
                'wq': torch.zeros(a['filters'], node.in_channels // a['groups'], a['size'],
                                  a['size'], dtype=torch.int8),
                'w_scale': torch.ones(a['filters']), 'b': torch.zeros(a['filters'])}
    return {'layers': layers, 'act': {}}


def test_regnety_graph_has_the_shapes_named():
    """regnety-400m-fpn's 25 grouped 3x3s (group width 8 and 16) take
    ``qgconv3x3_s8`` on their compact weights, none densified; they include
    stride 2 and Cin > 115 (the JAX package's densified range), and its 32
    SE 1x1s run at M = B."""
    net = DetectionNetwork.from_cfg(get_cfg('regnety-400m-fpn'), quant=True)
    layers = Int8Inference.prepare(_zero_qparams(net), network=net)['layers']
    grouped = [n for n in net.graph.nodes
               if n.kind == 'convolutional' and n.attrs['groups'] > 1]
    assert len(grouped) == 25 and all(
        layers[str(n.index)]['wg'].shape == (n.in_channels, 9 * n.in_channels // n.attrs['groups'])
        and 'wim' not in layers[str(n.index)] for n in grouped)
    assert {n.in_channels // n.attrs['groups'] for n in grouped} == {8, 16}
    assert any(n.attrs['stride'] == 2 for n in grouped)
    assert max(n.in_channels for n in grouped) == 440
    shapes = chip_smoke.int8_conv_shapes(net, 64)
    assert sum(c for k, c in shapes.items() if k[0] == 'pw' and k[1] == 1) == 32


def test_kernel_mode_matches_jax_pallas_and_int_oracle(calibrated, runs):
    """The port's kernel mode (plain kernels) against JAX's pallas mode and
    JAX's int oracle (grouped convs as feature_group_count convs): scores
    within 2e-2, boxes within 0.5 px; the scores spread."""
    ref = runs['oracle']
    assert ref[..., 4:].max() - ref[..., 4:].min() > 0.1
    for other in ('pallas', 'oracle'):
        out, want = runs['kernel'], runs[other]
        assert out.shape == want.shape and np.isfinite(out).all()
        np.testing.assert_allclose(out[..., 4:], want[..., 4:], atol=2e-2, rtol=0)
        np.testing.assert_allclose(out[..., :4], want[..., :4], atol=0.5, rtol=0)


def test_int_mode_matches_jax_int_oracle(calibrated, runs):
    """The integer modes of the two packages on grouped convs: the same
    arithmetic up to XLA's FMA in the epilogue, preds within 1e-4."""
    np.testing.assert_allclose(runs['int'], runs['oracle'], rtol=0, atol=1e-4)


def test_kernel_mode_conv_by_conv_matches_int_mode(calibrated):
    """Each conv of the kernel mode (grouped 3x3s through the grouped 3x3
    kernel or im2col, strided and SE 1x1s through the 1x1 kernel, all plain
    on the CPU) against the
    exact integer mode's grouped conv from the kernel mode's own input
    codes: chip_smoke's gate between the two modes."""
    net, qp = calibrated['net'], calibrated['qp']
    reading = chip_smoke.int8_modes_conv_parity(net, qp, torch.from_numpy(calibrated['x']))
    n_conv, worst, n_diff, n_all, bad_heads = reading
    assert n_conv == sum(n.kind == 'convolutional' for n in net.graph.nodes)
    assert chip_smoke.int8_modes_agree(*reading[1:]), reading


def test_kernel_mode_launches_no_kernel_on_the_cpu(calibrated):
    """On the CPU the kernel mode's wrappers run their plain versions and
    launch nothing; ``plain=True`` gives the same preds."""
    net = calibrated['net']
    staged = Int8Inference.prepare(calibrated['qp'], network=net)
    inf = Int8Inference(net)
    x = torch.from_numpy(calibrated['x'])
    before = (qconv1x1_s8.launches, qdwconv3x3_s8.launches)
    with torch.inference_mode():
        assert torch.equal(inf.apply(staged, x), inf.apply(staged, x, plain=True))
    assert (qconv1x1_s8.launches, qdwconv3x3_s8.launches) == before


def test_kernel_mode_serves_every_regnet_conv_off_the_cpu():
    """With ``prepare(network=)`` every conv of the five RegNet detectors has
    the kernel view its walk admits on the card (where a conv without one
    raises): a 1x1 (strided or not) its ``w2d`` at the full Cin, a
    depthwise 3x3 its ``wdw``, a grouped 3x3 its compact ``wg`` (Cin, 9 *
    group width), the dense stem its ``wim`` at im2col_depth(Cin)."""
    for name in ('regnetx-600m-fpn', 'regnetx-600m-pan', 'regnetx-600m-rpan',
                 'regnetx-600m-yolo', 'regnety-400m-fpn'):
        net = DetectionNetwork.from_cfg(get_cfg(name), quant=True)
        staged = Int8Inference.prepare(_zero_qparams(net), network=net)['layers']
        for node in net.graph.nodes:
            if node.kind != 'convolutional':
                continue
            p, a = staged[str(node.index)], node.attrs
            if a['size'] == 1:
                assert p['w2d'].shape[0] == node.in_channels, (name, node.index)
            elif a['groups'] == node.in_channels == a['filters']:
                assert 'wdw' in p, (name, node.index)
            elif a['groups'] > 1:
                gw = node.in_channels // a['groups']
                assert p['wg'].shape == (node.in_channels, 9 * gw), (name, node.index)
            else:
                assert p['wim'].shape[0] == im2col_depth(node.in_channels), (name, node.index)


def test_kernel_program_of_grouped_convs_equals_eager():
    """``export_stablehlo_quant(mode='kernel')`` of the grouped net stages the
    densified views (``prepare(network=)``) as buffers: the loaded program
    equals the eager kernel mode bit for bit."""
    from pqdet_tpu_torch.exporters.export import export_stablehlo_quant, load_stablehlo
    c = _calibrate('grouped')
    net, size = c['net'], c['size']
    blob = export_stablehlo_quant(net, c['qp'], (size, size), batch_size=2, mode='kernel',
                                  device='cpu')
    fn = load_stablehlo(blob, device='cpu')
    x = torch.from_numpy(c['x'])
    with torch.inference_mode():
        ref = Int8Inference(net).apply(Int8Inference.prepare(c['qp'], network=net), x)
        assert torch.equal(fn(x), ref)


def test_qat_on_grouped_weights_matches_jax():
    """QAT on grouped convs: the per-output-channel fake-quant of each
    grouped weight (OIHW, dim 0) equals JAX's on HWIO bit for bit, and the
    port's own observer passes on the carried weights give JAX's edge
    qparams (the bounds of tests/test_torch_int8.py's calibration test:
    scales within 3 %, zero points within 3)."""
    from pqdet_tpu.compress.qat import fake_quant_weight as jax_fake_quant_weight
    from pqdet_tpu_torch.bridge import from_jax_params
    from pqdet_tpu_torch.compress.qat import QuantCtx, fake_quant_weight, prepare_qat_state
    from pqdet_tpu_torch.compress.quantized import convert_to_int8
    cfg = _grouped_cfg()
    jnet = JaxNetwork.from_cfg(cfg, quant=True)
    params, state = jnet.init(jax.random.PRNGKey(0))
    net = DetectionNetwork.from_cfg(cfg, quant=True)
    for node in net.graph.nodes:
        if node.kind == 'convolutional' and node.attrs['groups'] > 1:
            w = np.asarray(params[str(node.index)]['w'])
            want = hwio_to_oihw(np.asarray(jax_fake_quant_weight(jnp.asarray(w))))
            got = fake_quant_weight(torch.from_numpy(hwio_to_oihw(w)))
            np.testing.assert_array_equal(got.numpy(), want)
    c = _calibrate('grouped')
    jparams, jstate = jnet.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    jparams = {k: {**v, 'w': v['w'] * GAIN} for k, v in jparams.items()}
    for k in jstate:          # _calibrate's seeded BN statistics, in its order
        n = np.asarray(jstate[k]['mean']).shape[0]
        jstate[k] = {'mean': rng.randn(n).astype(np.float32) * 0.1,
                     'var': rng.rand(n).astype(np.float32) * 0.4 + 0.8}
        jparams[k]['bn'] = {'gamma': rng.rand(n).astype(np.float32) * 0.4 + 0.8,
                            'beta': rng.randn(n).astype(np.float32) * 0.1}
    p, s = from_jax_params(jax.tree.map(np.asarray, jparams), jstate, net.graph, device='cpu')
    p, s = prepare_qat_state(net, p, s)
    with torch.inference_mode():
        for seed in (1, 2):
            x = np.random.RandomState(seed).rand(2, c['size'], c['size'], 3).astype(np.float32)
            ctx = QuantCtx(s['quant'], observing=True)
            net(p, s, torch.from_numpy(x * 2 - 1), quant_ctx=ctx)
            s = {**s, 'quant': ctx.new_obs}
    act = convert_to_int8(net, p, s)['act']
    assert sorted(act) == sorted(c['qparams']['act'])
    for edge, (scale, zp) in c['qparams']['act'].items():
        np.testing.assert_allclose(act[edge][0], scale, rtol=3e-2)
        assert abs(act[edge][1] - zp) <= 3, edge
