"""The port's NAS search space (``pqdet_tpu_torch/nas/space.py``,
``nas/detnet.py``, ``nas/search.py::generate_candidates``) against the JAX
package's on the CPU: the RegNet width math of every named config, the head
sampler, the candidates' cfg text letter for letter, their MACs, params and
heads, and one candidate's forward on JAX's weights.

Seed 0's candidate 1 has group width 1 in its head, so each head block is a
1x1 -> depthwise 3x3 -> 1x1 chain that ``find_fused_triples`` fuses (12
chains, E 32, 112 and 144): its forward runs the fused chains through
``fused_ir_reference`` here and through ``fused_ir_conv`` on the card.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
from pqdet_tpu.model.network import fuse_params as jax_fuse_params
from pqdet_tpu.nas import detnet as jax_detnet
from pqdet_tpu.nas import search as jax_search
from pqdet_tpu.nas import space as jax_space
from pqdet_tpu.ops.pallas_fused import prepare_fused_ir as jax_prepare_fused_ir
from pqdet_tpu_torch.bridge import from_jax_params
from pqdet_tpu_torch.model.graph import Graph
from pqdet_tpu_torch.model.network import DetectionNetwork, cast_params, fuse_params
from pqdet_tpu_torch.nas import detnet, search, space
from pqdet_tpu_torch.ops.fused_ir import find_fused_triples, prepare_fused_ir
from pqdet_tpu_torch.utils.profiling import count_macs_params

SIZE = 64
GAIN = 1.5          # tests/test_torch_regnet.py's weight gain: the scores spread


@pytest.mark.parametrize('name', sorted(jax_space.REGNET_CONFIGS))
def test_regnet_width_math_equals_jax(name):
    assert space.REGNET_CONFIGS[name] == jax_space.REGNET_CONFIGS[name]
    c = space.REGNET_CONFIGS[name]
    ws = space.generate_widths(c['wa'], c['w0'], c['wm'], c['depth'])
    assert ws == jax_space.generate_widths(c['wa'], c['w0'], c['wm'], c['depth'])
    stages = space.widths_to_stages(ws)
    assert stages == jax_space.widths_to_stages(ws)
    gws = [c['group_w']] * len(stages[0])
    assert space.adjust_widths_groups(stages[0], gws) == \
        jax_space.adjust_widths_groups(stages[0], gws)
    assert space.adjust_widths_groups(stages[0], gws, [0.5] * len(gws)) == \
        jax_space.adjust_widths_groups(stages[0], gws, [0.5] * len(gws))
    assert space.regnet_stages(c) == jax_space.regnet_stages(c)


@pytest.mark.parametrize('seed', range(10))
def test_sample_head_equals_jax(seed):
    rng, jrng = np.random.RandomState(seed), np.random.RandomState(seed)
    heads = [space.sample_head(rng) for _ in range(3)]
    assert heads == [jax_space.sample_head(jrng) for _ in range(3)]
    assert all(w % g == 0 for h in heads for w, g in zip(h['widths'], h['group_ws']))


@pytest.mark.parametrize('seed', range(5))
def test_detnet_cfg_text_equals_jax(seed):
    """``detnet_600m`` draws the same head and writes JAX's cfg text; so does
    ``build_detnet_cfg`` at other classes, loss and exp_cap."""
    cfg, head = detnet.detnet_600m(num_classes=20, rng=np.random.RandomState(seed),
                                   return_head=True)
    jcfg, jhead = jax_detnet.detnet_600m(num_classes=20, rng=np.random.RandomState(seed),
                                         return_head=True)
    assert head == jhead and cfg == jcfg
    backbone = space.regnet_stages(space.REGNET_CONFIGS['600M'])
    kw = dict(num_classes=3, gt_per_grid=3, bbox_loss='ciou', exp_cap=0.0)
    assert detnet.build_detnet_cfg(backbone, head, **kw) == \
        jax_detnet.build_detnet_cfg(backbone, head, **kw)
    graph = Graph.from_cfg(cfg)
    assert sorted(n.stride for n in graph.yolo_nodes) == [8, 16, 32]
    assert all(n.attrs['exp_cap'] == 40.0 for n in graph.yolo_nodes)


@pytest.fixture(scope='module')
def candidates():
    """``generate_candidates(8, seed=0)`` of both packages (no latency
    filter: nothing runs a forward)."""
    port = list(search.generate_candidates(8, seed=0, device='cpu'))
    jax_ = list(jax_search.generate_candidates(8, seed=0))
    return port, jax_


@pytest.mark.parametrize('k', range(8))
def test_generate_candidates_equal_jax(candidates, k):
    """Candidate k of seed 0: JAX's cfg text, MACs, params and head."""
    port, jax_ = candidates
    assert len(port) == len(jax_) == 8
    (cfg, info), (jcfg, jinfo) = port[k], jax_[k]
    assert cfg == jcfg
    assert info == jinfo
    assert (info['macs'], info['params']) == count_macs_params(Graph.from_cfg(cfg), (512, 512))
    assert info['macs'] <= 5e9


def test_seed0_candidate1_has_the_group_width_1_chains(candidates):
    """Candidate 1 of seed 0: head widths [112, 144, 32], depth 4, group width
    1, and 12 fused chains (Cin 528/112 -> E 112, Cin 384/144 -> E 144,
    Cin 128/32 -> E 32); candidates 0 and 2 have none."""
    port, _ = candidates
    assert port[1][1]['head'] == {'widths': [112, 144, 32], 'depth': 4, 'group_ws': [1, 1, 1]}
    chains = [find_fused_triples(Graph.from_cfg(cfg)) for cfg, _ in port[:3]]
    assert [len(c) for c in chains] == [0, 12, 0]
    g = Graph.from_cfg(port[1][0])
    nodes = {n.index: n for n in g.nodes}
    shapes = sorted({(nodes[a].in_channels, nodes[b].in_channels, nodes[b].stride)
                     for a, b, _ in chains[1]})
    assert shapes == [(32, 32, 8), (112, 112, 32), (128, 32, 8), (144, 144, 16),
                      (384, 144, 16), (528, 112, 32)]


def _seeded(jnet, seed=0):
    """JAX's init with every conv weight times GAIN and seeded BN
    statistics (tests/test_torch_regnet.py's weights)."""
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


def test_candidate_forward_matches_jax(candidates):
    """Seed 0's candidate 1 at 64 px on JAX's weights: the port's f32 walk
    within tests/test_torch_regnet.py's bounds of JAX's ``net.apply`` (one
    jitted JAX call); the fused-IR table on the BN-folded weights is JAX's,
    and the bf16 walk through it (``fused_ir_reference`` on the CPU) within
    phase 4's bounds of the same preds (scores 0.03, boxes 1.5 px)."""
    cfg = candidates[0][1][0]
    jnet, net = JaxNetwork.from_cfg(cfg), DetectionNetwork.from_cfg(cfg)
    params, state = _seeded(jnet)
    x = np.random.RandomState(1).rand(2, SIZE, SIZE, 3).astype(np.float32)
    ref, _ = jax.jit(lambda p, s, x: jnet.apply(p, s, x))(params, state, jnp.asarray(x))
    ref = np.asarray(ref)
    p, s = from_jax_params(params, state, net.graph, device='cpu')
    fused = fuse_params(net, p, s)
    table = prepare_fused_ir(net, fused)
    jtable = jax_prepare_fused_ir(jnet, jax_fuse_params(jnet, params, state))
    assert len(table) == 12 and sorted(table) == sorted(jtable)
    assert all(set(table[k]['skip']) == set(jtable[k]['skip']) for k in table)
    with torch.inference_mode():
        out = net(fused, {}, torch.from_numpy(x)).numpy()
        bf = net(cast_params(fused, torch.bfloat16), {}, torch.from_numpy(x),
                 compute_dtype=torch.bfloat16, fused_ir=table).numpy()
    assert out.shape == ref.shape == (2, (8 * 8 + 4 * 4 + 2 * 2) * 3, 25)
    assert ref[..., 4:].max() - ref[..., 4:].min() > 0.2          # the scores spread
    assert np.isfinite(ref).all() and np.isfinite(bf).all()
    np.testing.assert_allclose(out[..., 4:], ref[..., 4:], rtol=0, atol=1e-5)
    np.testing.assert_allclose(out[..., :4], ref[..., :4], rtol=1e-5, atol=1e-4)
    assert np.abs(bf[..., 4:] - ref[..., 4:]).max() <= 0.03
    assert np.abs(bf[..., :4] - ref[..., :4]).max() <= 1.5
