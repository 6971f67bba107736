"""Checkpoints across the two packages on the CPU: a file written by the JAX
package loads into the port, and one written by the port loads in JAX's
``load_checkpoint`` and ``load_weights_into``, every array bit for bit;
the port's codec gives flax's bytes; strict loads name their mismatch;
the backbone subset matches JAX's; ``build_detector`` rebuilds a model
from a checkpoint's embedded cfg."""

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from pqdet_tpu.model.factory import build_detector as jax_build_detector
from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
from pqdet_tpu.train.checkpoint import load_backbone_into as jax_load_backbone_into
from pqdet_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from pqdet_tpu.train.checkpoint import load_weights_into as jax_load_weights_into
from pqdet_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from pqdet_tpu.zoo import get_cfg as jax_get_cfg
from pqdet_tpu.zoo.mobilenetv2 import mobilenetv2_fpn as jax_mobilenetv2_fpn
from pqdet_tpu_torch.bridge import from_jax_params, to_jax_params
from pqdet_tpu_torch.model.factory import build_detector, inference_params
from pqdet_tpu_torch.model.network import DetectionNetwork, fuse_params
from pqdet_tpu_torch.train.checkpoint import (load_backbone_into, load_weights_into,
                                              save_checkpoint)
from pqdet_tpu_torch.train.step import tree_leaves
from pqdet_tpu_torch.utils.codec import dumps, load_checkpoint, loads
from pqdet_tpu_torch.zoo import get_cfg

CFG = get_cfg('mobilenetv2-fpn', num_classes=3, width_mult=0.25)


@pytest.fixture(scope='module')
def jax_model():
    assert CFG == jax_mobilenetv2_fpn(num_classes=3, width_mult=0.25)
    jnet = JaxNetwork.from_cfg(CFG)
    params, state = jax.device_get(jnet.init(jax.random.PRNGKey(3)))
    # running statistics that are not the init's ones and zeros
    rng = np.random.RandomState(0)
    state = {k: {'mean': rng.randn(*v['mean'].shape).astype(np.float32),
                 'var': rng.rand(*v['var'].shape).astype(np.float32) + 0.5}
             for k, v in state.items()}
    return jnet, params, state


def _flat_np(tree, prefix=''):
    if isinstance(tree, tuple):
        tree = dict(enumerate(tree))
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in _flat_np(tree[k], f'{prefix}/{k}').items()}
    return {prefix: np.asarray(tree)}


def _assert_trees_equal(a, b):
    fa, fb = _flat_np(a), _flat_np(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _assert_port_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    assert all(torch.equal(x, y) for x, y in zip(la, lb))


def test_jax_file_loads_into_the_port(jax_model, tmp_path):
    jnet, params, state = jax_model
    path = str(tmp_path / 'jax.ckpt')
    jax_save_checkpoint(path, params, state, step=17, cfg_text=CFG, ap=0.25)
    ckpt = load_checkpoint(path)
    assert (ckpt['step'], ckpt['AP'], ckpt['cfg'], ckpt['type'], ckpt['backend']) == \
        (17, 0.25, CFG, 'normal', 'none')
    net = DetectionNetwork.from_cfg(CFG)
    tp, ts = net.init(torch.Generator().manual_seed(0), device='cpu')
    lp, ls = load_weights_into(net.graph, tp, ts, ckpt)
    wp, ws = from_jax_params(params, state, net.graph, device='cpu')
    _assert_port_equal(lp, wp)
    _assert_port_equal(ls, ws)


def test_port_file_loads_in_jax(jax_model, tmp_path):
    """JAX -> port -> file -> JAX: the arrays JAX loads are its own, bit for
    bit, and the port's own (params, state) in JAX's layout."""
    jnet, params, state = jax_model
    net = DetectionNetwork.from_cfg(CFG)
    tp, ts = from_jax_params(params, state, net.graph, device='cpu')
    path = str(tmp_path / 'port.ckpt')
    save_checkpoint(path, net.graph, tp, ts, step=5, cfg_text=CFG, ap=None)
    ckpt = jax_load_checkpoint(path)
    assert (ckpt['step'], ckpt['AP'], ckpt['cfg'], ckpt['type'], ckpt['backend']) == \
        (5, -1.0, CFG, 'normal', 'none')
    template_p, template_s = jnet.init(jax.random.PRNGKey(9))
    lp, ls = jax_load_weights_into(template_p, template_s, ckpt)
    _assert_trees_equal(lp, params)
    _assert_trees_equal(ls, state)
    _assert_trees_equal((lp, ls), to_jax_params(tp, ts, net.graph))


def test_codec_gives_flax_bytes(jax_model, tmp_path):
    """The same weights saved by both packages give the same file, and the
    codec equals flax's msgpack_serialize on a payload with numpy scalars
    (ext type 3) and nested dicts in unsorted order."""
    jnet, params, state = jax_model
    net = DetectionNetwork.from_cfg(CFG)
    tp, ts = from_jax_params(params, state, net.graph, device='cpu')
    jax_save_checkpoint(str(tmp_path / 'a.ckpt'), params, state, step=3, cfg_text=CFG, ap=0.5)
    save_checkpoint(str(tmp_path / 'b.ckpt'), net.graph, tp, ts, step=3, cfg_text=CFG, ap=0.5)
    blob = (tmp_path / 'a.ckpt').read_bytes()
    assert blob == (tmp_path / 'b.ckpt').read_bytes() and len(blob) > 10000
    payload = {'z': {'10': np.arange(6, dtype=np.int32).reshape(2, 3), '9': np.float32(1.5)},
               'a': np.float64(2.0), 'k': [1, 2], 's': 'text', 'n': 7, 'f': 0.125,
               'b': np.zeros((0, 4), np.float32)}
    assert dumps(payload) == serialization.msgpack_serialize(payload)
    back = loads(dumps(payload))
    assert back['z']['9'] == np.float32(1.5) and isinstance(back['z']['9'], np.float32)
    np.testing.assert_array_equal(back['z']['10'], payload['z']['10'])


def _ckpt(jax_model):
    jnet, params, state = jax_model
    return {'step': 0, 'AP': -1.0, 'params': params, 'state': state, 'cfg': CFG,
            'type': 'normal', 'backend': 'none'}


@pytest.mark.parametrize('edit,match', [
    (lambda c: c['params'].pop('0'), r"missing \['0'\]"),
    (lambda c: c['params'].update({'999': {'w': np.zeros(1)}}), r"unexpected \['999'\]"),
    (lambda c: c['params']['0'].update({'w': np.zeros((3, 3, 3, 1), np.float32)}),
     'shape mismatch at /0/w'),
    (lambda c: c['state']['0'].pop('var'), r"/0: missing \['var'\]"),
])
def test_strict_load_names_the_mismatch(jax_model, edit, match):
    ckpt = _ckpt(jax_model)
    ckpt['params'] = {k: dict(v) for k, v in ckpt['params'].items()}
    ckpt['state'] = {k: dict(v) for k, v in ckpt['state'].items()}
    edit(ckpt)
    net = DetectionNetwork.from_cfg(CFG)
    tp, ts = net.init(torch.Generator().manual_seed(0), device='cpu')
    with pytest.raises(ValueError, match=match):
        load_weights_into(net.graph, tp, ts, ckpt)


def test_backbone_subset_matches_jax(jax_model):
    """A 3-class checkpoint into a 20-class model: every layer but the head
    convs comes from the checkpoint, as in JAX's load_backbone_into."""
    ckpt = _ckpt(jax_model)
    cfg20 = get_cfg('mobilenetv2-fpn', num_classes=20, width_mult=0.25)
    jnet = JaxNetwork.from_cfg(cfg20)
    jp, js = jax.device_get(jnet.init(jax.random.PRNGKey(4)))
    want_p, want_s = jax_load_backbone_into(jp, js, ckpt)
    net = DetectionNetwork.from_cfg(cfg20)
    tp, ts = from_jax_params(jp, js, net.graph, device='cpu')
    got_p, got_s = load_backbone_into(net.graph, tp, ts, ckpt)
    _assert_trees_equal(to_jax_params(got_p, got_s, net.graph), (want_p, want_s))
    heads = [str(y.index - 1) for y in net.graph.yolo_nodes]
    assert all(not np.array_equal(want_p[h]['w'], ckpt['params'][h]['w'])
               for h in heads if want_p[h]['w'].shape == ckpt['params'][h]['w'].shape) \
        and any(want_p[h]['w'].shape != ckpt['params'][h]['w'].shape for h in heads)


def test_build_detector_from_checkpoint(jax_model, tmp_path):
    """No cfg given: the architecture comes from the checkpoint's cfg text,
    its weights load strictly, info carries step and AP (step 0 with
    clear_history); the BN-folded inference params are the walk's."""
    jnet, params, state = jax_model
    path = str(tmp_path / 'm.ckpt')
    jax_save_checkpoint(path, params, state, step=40, cfg_text=CFG, ap=0.125)
    net, p, s, info = build_detector(weight_path=path, device='cpu')
    assert info == {'step': 40, 'AP': 0.125, 'type': 'normal', 'cfg_text': CFG}
    assert len(net.graph.nodes) == len(jnet.graph.nodes)
    wp, ws = from_jax_params(params, state, net.graph, device='cpu')
    _assert_port_equal(p, wp)
    _assert_port_equal(s, ws)
    assert build_detector(weight_path=path, clear_history=True, device='cpu')[3]['step'] == 0
    fused = inference_params(net, p, s, dtype=torch.bfloat16)
    ref = fuse_params(net, wp, ws)
    assert all(torch.equal(a, b.to(torch.bfloat16))
               for a, b in zip(tree_leaves(fused), tree_leaves(ref)))
    fresh = build_detector(CFG, rng_seed=1, device='cpu')
    again = build_detector(CFG, rng_seed=1, device='cpu')
    _assert_port_equal(fresh[1], again[1])
    assert fresh[3]['step'] == 0 and fresh[3]['AP'] is None


def test_build_detector_queued_paths_raise(jax_model, tmp_path):
    """Named for the paths that raise: a quant checkpoint (int8 weights go
    through load_quantized), no cfg. ``qat=True``, which raised before the
    QAT slice, builds JAX's quant graph with its fresh observers; a grouped
    conv, which raised before the RegNet slice, builds with JAX's params in
    the port's layout."""
    jnet, params, state = jax_model
    net, p, s, _ = build_detector(CFG, qat=True, device='cpu')
    qnet, _, qs, _ = jax_build_detector(CFG, qat=True)
    assert [n.attrs.get('activation') for n in net.graph.nodes] == \
        [n.attrs.get('activation') for n in qnet.graph.nodes]
    assert sorted(s['quant']) == sorted(qs['quant']) and len(s['quant']) > 50
    assert not any(bool(o['initialized']) for o in s['quant'].values())
    path = str(tmp_path / 'q.ckpt')
    jax_save_checkpoint(path, params, state, step=1, cfg_text=CFG, ckpt_type='quant')
    with pytest.raises(ValueError, match='int8 weights'):
        build_detector(weight_path=path, device='cpu')
    rcfg = jax_get_cfg('regnetx-600m-fpn', num_classes=3)
    rnet, rp, rs, _ = build_detector(rcfg, device='cpu')
    jp, js = JaxNetwork.from_cfg(rcfg).init(jax.random.PRNGKey(0))
    want_p, want_s = to_jax_params(rp, rs, rnet.graph)
    assert jax.tree.map(np.shape, want_p) == jax.tree.map(np.shape, jax.tree.map(np.asarray, jp))
    assert jax.tree.map(np.shape, want_s) == jax.tree.map(np.shape, jax.tree.map(np.asarray, js))
    with pytest.raises(ValueError, match='need a model cfg'):
        build_detector(device='cpu')
