"""The RegNet zoo of the port (``pqdet_tpu_torch/zoo/regnet.py``,
``zoo/classifier.py``) against the JAX package's on the CPU: the cfg text of
the five detectors and three classifiers byte for byte, the parameter
counts of the reference zoo, the f32 forward of regnetx-600m-fpn and
regnety-400m-fpn on JAX's weights carried by ``bridge.from_jax_params``,
``densify_grouped_convs`` and ``ClassifierNetwork``.

Weights: JAX's init with every conv weight scaled by GAIN and seeded BN
statistics. At JAX's init the scores spread only ~0.01 at 64 px (every
score near 0.5), which would hide a wrong head; with GAIN 1.5 they spread
over ~0.25-0.75 and the boxes stay finite (a gain of 2 grows the residual
stages until exp overflows).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pqdet_tpu.model.network import ClassifierNetwork as JaxClassifier
from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
from pqdet_tpu.model.network import densify_grouped_convs as jax_densify
from pqdet_tpu.model.network import fuse_params as jax_fuse_params
from pqdet_tpu.ops.pallas_fused import find_fused_triples as jax_find_fused_triples
from pqdet_tpu.ops.pallas_fused import prepare_fused_ir as jax_prepare_fused_ir
from pqdet_tpu.zoo import CLASSIFIER_ZOO as JAX_CLASSIFIER_ZOO
from pqdet_tpu.zoo import MODEL_ZOO as JAX_MODEL_ZOO
from pqdet_tpu.zoo import get_cfg as jax_get_cfg
from pqdet_tpu.zoo import get_classifier_cfg as jax_get_classifier_cfg
from pqdet_tpu.zoo.builder import CfgBuilder as JaxCfgBuilder
from pqdet_tpu_torch.bridge import from_jax_params
from pqdet_tpu_torch.model import layers as L
from pqdet_tpu_torch.model.factory import inference_params
from pqdet_tpu_torch.model.network import (ClassifierNetwork, DetectionNetwork,
                                           densify_grouped_convs, fuse_params)
from pqdet_tpu_torch.ops.fused_ir import find_fused_triples, prepare_fused_ir
from pqdet_tpu_torch.train.step import tree_leaves
from pqdet_tpu_torch.utils.profiling import count_macs_params
from pqdet_tpu_torch.zoo import CLASSIFIER_ZOO, MODEL_ZOO, get_cfg, get_classifier_cfg

SIZE = 64
GAIN = 1.5


def seeded(jnet, seed=0):
    """JAX's init of ``jnet`` with every conv weight times GAIN and seeded
    BN statistics (numpy arrays)."""
    params, state = jnet.init(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.RandomState(seed)
    for k, p in params.items():
        if p['w'].ndim == 4:
            p['w'] = p['w'] * GAIN
        if 'bn' in p:
            c = p['w'].shape[-1]
            p['bn'] = {'gamma': (rng.rand(c) * 0.4 + 0.8).astype(np.float32),
                       'beta': (rng.randn(c) * 0.1).astype(np.float32)}
            state[k] = {'mean': (rng.randn(c) * 0.1).astype(np.float32),
                        'var': (rng.rand(c) * 0.4 + 0.8).astype(np.float32)}
    return params, state


def test_zoo_names_match_jax():
    # the port's zoo is JAX's and yolov3 (zoo/darknet.py), which JAX lacks
    assert sorted(MODEL_ZOO) == sorted([*JAX_MODEL_ZOO, 'yolov3'])
    assert sorted(CLASSIFIER_ZOO) == sorted(JAX_CLASSIFIER_ZOO)


@pytest.mark.parametrize('name', sorted(JAX_MODEL_ZOO) + [f'classifier:{n}'
                                                          for n in sorted(JAX_CLASSIFIER_ZOO)])
def test_cfg_text_equals_jax(name):
    """The generators' cfg text byte for byte, at the default classes and
    at 3 (the shapes corpus)."""
    if name.startswith('classifier:'):
        name = name.split(':', 1)[1]
        for nc in (1000, 10):
            assert get_classifier_cfg(name, nc) == jax_get_classifier_cfg(name, nc)
        return
    for nc in (20, 3):
        assert get_cfg(name, num_classes=nc) == jax_get_cfg(name, num_classes=nc)


@pytest.mark.parametrize('name,ref', [('regnetx-600m-fpn', 7.417e6),
                                      ('regnetx-600m-pan', 7.145e6),
                                      ('regnety-400m-fpn', 5.581e6)])
def test_param_counts_match_reference_zoo(name, ref):
    """The reference zoo's parameter counts (tests/test_graph.py), from the
    port's init, equal to what ``count_macs_params`` reports."""
    net = DetectionNetwork.from_cfg(get_cfg(name))
    params, _ = net.init(torch.Generator().manual_seed(0), device='cpu')
    n = sum(t.numel() for t in tree_leaves(params))
    assert abs(n - ref) / ref < 0.001, (name, n, ref)
    assert n == count_macs_params(net.graph, (512, 512))[1]


@pytest.fixture(scope='module', params=['regnetx-600m-fpn', 'regnety-400m-fpn'])
def fpn_case(request):
    """(name, port net, port params, port state, JAX preds, input)."""
    cfg = get_cfg(request.param)
    jnet = JaxNetwork.from_cfg(cfg)
    params, state = seeded(jnet)
    x = np.random.RandomState(1).rand(2, SIZE, SIZE, 3).astype(np.float32)
    ref, _ = jax.jit(lambda p, s, x: jnet.apply(p, s, x))(params, state, jnp.asarray(x))
    net = DetectionNetwork.from_cfg(cfg)
    p, s = from_jax_params(params, state, net.graph, device='cpu')
    return request.param, net, p, s, np.asarray(ref), x


@pytest.mark.parametrize('densify', [True, False])
def test_forward_matches_jax(fpn_case, densify):
    """The port's f32 inference walk on JAX's weights, grouped convs
    densified (the serving default) or run grouped: scores within 1e-5,
    boxes within 1e-5 of their magnitude (both sides sum each conv in f32
    in another order)."""
    _, net, p, s, ref, x = fpn_case
    fused = inference_params(net, p, s, densify_groups=densify)
    with torch.inference_mode():
        out = net(fused, {}, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, (8 * 8 + 4 * 4 + 2 * 2) * 3, 25)
    assert ref[..., 4:].max() - ref[..., 4:].min() > 0.2          # the scores spread
    assert np.isfinite(ref).all() and np.abs(ref[..., :4]).max() < 1e4
    np.testing.assert_allclose(out[..., 4:], ref[..., 4:], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out[..., :4], ref[..., :4], rtol=1e-5, atol=1e-4)


def _grouped_cfg(nc=3):
    """tests/test_layers.py's densify cfg: group widths 4 and 8 and a
    depthwise conv (kept grouped)."""
    b = JaxCfgBuilder()
    b.conv(16, size=3, stride=2, activation='relu')
    b.conv(32, size=3, stride=2, groups=4, activation='relu')   # group width 4
    b.conv(32, size=3, groups=32, activation='relu')            # depthwise (kept)
    b.conv(48, size=3, groups=8, activation='relu')             # group width 4
    b.conv(3 * (5 + nc), size=1, bn=False, activation='linear')
    b.yolo(nc)
    return b.text()


def test_densify_grouped_convs_matches_jax_and_preserves_function():
    """JAX's densified weights, carried across, equal the port's
    densification of the carried grouped weights bit for bit (OIHW); the
    depthwise conv stays grouped; the dense walk gives the grouped walk's
    preds (1e-5)."""
    cfg = _grouped_cfg()
    jnet = JaxNetwork.from_cfg(cfg)
    params, state = seeded(jnet)
    jfused = jax_fuse_params(jnet, params, state)
    jdense = jax.tree.map(np.asarray, jax_densify(jnet, jfused))
    net = DetectionNetwork.from_cfg(cfg)
    fused, _ = from_jax_params(jax.tree.map(np.asarray, jfused), {}, net.graph, device='cpu')
    want, _ = from_jax_params(jdense, {}, net.graph, device='cpu')
    dense = densify_grouped_convs(net, fused)
    assert dense['2']['w'].shape == fused['2']['w'].shape == (32, 1, 3, 3)
    assert dense['1']['w'].shape == (32, 16, 3, 3) and fused['1']['w'].shape == (32, 4, 3, 3)
    assert dense['3']['w'].shape == (48, 32, 3, 3)
    for k in want:
        assert torch.equal(dense[k]['w'], want[k]['w']), k
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 32, 32, 3).astype(np.float32))
    with torch.inference_mode():
        np.testing.assert_allclose(net(dense, {}, x).numpy(), net(fused, {}, x).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_densified_weight_gradient_is_the_grouped_gradient():
    """``densify_grouped_weight`` under autograd: a dense conv on the
    expanded weights has the grouped conv's output and its input and
    weight gradients, the latter in the compact grouped form (JAX's
    tests/test_layers.py parity, on OIHW)."""
    rng = np.random.RandomState(7)
    groups, cin, cout = 4, 24, 40
    w = torch.tensor(rng.randn(cout, cin // groups, 3, 3) * 0.1, dtype=torch.float32,
                     requires_grad=True)
    x = torch.tensor(rng.randn(2, 14, 14, cin), dtype=torch.float32, requires_grad=True)
    y0 = L.conv2d(x, w, padding=1, groups=groups)
    g0 = torch.autograd.grad(torch.tanh(y0).sum(), (w, x))
    dense = L.densify_grouped_weight(w, groups)
    assert dense.shape == (cout, cin, 3, 3)
    y1 = L.conv2d(x, dense, padding=1, groups=groups)
    g1 = torch.autograd.grad(torch.tanh(y1).sum(), (w, x))
    np.testing.assert_allclose(y1.detach().numpy(), y0.detach().numpy(), rtol=1e-5, atol=1e-5)
    assert g1[0].shape == w.shape
    for a, b in zip(g1, g0):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize('name', sorted(JAX_CLASSIFIER_ZOO))
def test_classifier_logits_match_jax(name):
    """``ClassifierNetwork`` of each classifier zoo cfg on JAX's weights
    (the fc carried from (in, out) to torch's (out, in)): (B, 1000) logits
    within 1e-4 of their scale, with and without the BN fold."""
    cfg = get_classifier_cfg(name)
    jnet = JaxClassifier.from_cfg(cfg)
    params, state = seeded(jnet)
    x = np.random.RandomState(2).rand(2, SIZE, SIZE, 3).astype(np.float32)
    ref, _ = jax.jit(lambda p, s, x: jnet.apply(p, s, x))(params, state, jnp.asarray(x))
    ref = np.asarray(ref)
    net = ClassifierNetwork.from_cfg(cfg)
    p, s = from_jax_params(params, state, net.graph, device='cpu')
    with torch.inference_mode():
        out = net(p, s, torch.from_numpy(x)).numpy()
        folded = net(fuse_params(net, p, s), {}, torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape == (2, 1000) and np.isfinite(ref).all()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(folded, ref, rtol=0, atol=1e-4 * scale)


@pytest.mark.parametrize('name', sorted(n for n in JAX_MODEL_ZOO if n.startswith('regnet')))
def test_fused_chains_match_jax(name):
    """The fused-IR chains of each RegNet graph are JAX's (9 in
    regnetx-600m-yolo's head, two of them bare pairs; none in the others),
    and the table on BN-folded weights starts and skips where JAX's does."""
    cfg = get_cfg(name)
    jnet, net = JaxNetwork.from_cfg(cfg), DetectionNetwork.from_cfg(cfg)
    triples = find_fused_triples(net.graph)
    assert triples == jax_find_fused_triples(jnet.graph)
    assert len(triples) == (9 if name == 'regnetx-600m-yolo' else 0)
    if not triples:
        return
    params, state = jnet.init(jax.random.PRNGKey(0))
    jfused = jax_fuse_params(jnet, params, state)
    fused = inference_params(net, *from_jax_params(params, state, net.graph, device='cpu'))
    table, jtable = prepare_fused_ir(net, fused), jax_prepare_fused_ir(jnet, jfused)
    assert sorted(table) == sorted(jtable)
    for k in table:
        assert set(table[k]['skip']) == set(jtable[k]['skip']) and table[k]['end'] == jtable[k]['end']


@pytest.mark.parametrize('yaml_name', ['coco.yaml', 'visdrone.yaml'])
def test_shipped_yaml_models_resolve_as_jax(yaml_name):
    """yamls/coco.yaml and yamls/visdrone.yaml name regnetx-600m-fpn: its
    cfg text at their class counts, JAX's."""
    from pathlib import Path
    from pqdet_tpu.config import load_config as jax_load_config
    from pqdet_tpu.config import resolve_model_cfg as jax_resolve_model_cfg
    from pqdet_tpu_torch.config import load_config, resolve_model_cfg
    path = str(Path(__file__).resolve().parent.parent / 'yamls' / yaml_name)
    cfg = load_config(path)
    assert cfg.model.cfg_path == 'regnetx-600m-fpn'
    assert resolve_model_cfg(cfg) == jax_resolve_model_cfg(jax_load_config(path))
