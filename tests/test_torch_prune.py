"""The port's slimming pruner (``pqdet_tpu_torch/compress/prune.py``) and
profiling (``utils/profiling.py``) against the JAX package's.

The same numpy params, made from a seed, go through JAX's
``prune_slimming`` and the port's, on JAX's small graph of every prune
rule (``tests/test_prune.py``) and on the full-width mobilenetv2-fpn, at
ratios 0.1, 0.3 and 0.5 and one above ``prune_limit``, with distinct and
with tied |gamma|: the cfg text, the report, ``prune_limit`` and every
pruned array (in JAX's layout) must be equal. Then the port's own
function-preservation check, the pruned model's f32 forward against JAX's,
the grouped-conv refusal, the fused chains JAX picks on the pruned graph,
and the MACs and params of thop's convention.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqdet_tpu.compress.prune import prune_slimming as jax_prune_slimming
from pqdet_tpu.model.graph import Graph as JaxGraph
from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
from pqdet_tpu.ops.pallas_fused import find_fused_triples as jax_find_fused_triples
from pqdet_tpu.utils.profiling import clever_format as jax_clever_format
from pqdet_tpu.utils.profiling import count_macs_params as jax_count_macs_params
from pqdet_tpu_torch.bridge import from_jax_params, to_jax_params
from pqdet_tpu_torch.compress.prune import prune_slimming
from pqdet_tpu_torch.model.graph import Graph
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.ops.fused_ir import find_fused_triples
from pqdet_tpu_torch.utils.profiling import clever_format, count_macs_params
from pqdet_tpu_torch.zoo import get_cfg
from pqdet_tpu_torch.zoo.builder import CfgBuilder
from test_prune import _mobile_style_cfg

GRAPHS = {'mobile': lambda: _mobile_style_cfg(),
          'mobilenetv2-fpn': lambda: get_cfg('mobilenetv2-fpn')}


def seeded_params(cfg_text, seed=0, ties=False):
    """numpy (params, state) in JAX's layout: the port's init of
    ``cfg_text`` with every BN gamma, beta, mean and var drawn from
    ``RandomState(seed)`` (gammas of either sign; with ``ties`` on a grid of
    five magnitudes, so many tie)."""
    net = DetectionNetwork.from_cfg(cfg_text)
    p, s = net.init(torch.Generator().manual_seed(seed), device='cpu')
    params, state = to_jax_params(p, s, net.graph)
    rng = np.random.RandomState(seed)
    for key in sorted(params, key=int):
        bn = params[key].get('bn')
        if bn is None:
            continue
        c = bn['gamma'].shape[0]
        g = rng.uniform(0.0, 1.0, c)
        if ties:
            g = np.round(g * 4) / 4
        bn['gamma'] = (g * rng.choice([-1.0, 1.0], c)).astype(np.float32)
        bn['beta'] = rng.normal(0.0, 0.1, c).astype(np.float32)
        state[key] = {'mean': rng.normal(0.0, 0.1, c).astype(np.float32),
                      'var': rng.uniform(0.5, 1.5, c).astype(np.float32)}
    return params, state


@functools.lru_cache(maxsize=None)
def pruned_mobilenetv2_cfg(ratio=0.3, seed=0):
    """The cfg text of mobilenetv2-fpn (20 classes) pruned at ``ratio`` from
    ``seeded_params``."""
    cfg = get_cfg('mobilenetv2-fpn')
    params, state = seeded_params(cfg, seed)
    graph = Graph.from_cfg(cfg)
    p, s = from_jax_params(params, state, graph, device='cpu')
    return prune_slimming(graph, p, s, ratio).cfg_text


def _assert_trees_equal(got, want, path=''):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(got[k], want[k], f'{path}/{k}')
        else:
            a, b = np.asarray(got[k]), np.asarray(want[k])
            assert a.dtype == b.dtype and a.shape == b.shape, f'{path}/{k}'
            assert np.array_equal(a, b), f'{path}/{k}'


@pytest.mark.parametrize('ties', [False, True], ids=['distinct', 'ties'])
@pytest.mark.parametrize('ratio', [0.1, 0.3, 0.5, 'above-limit'])
@pytest.mark.parametrize('name', sorted(GRAPHS))
def test_prune_slimming_matches_jax(name, ratio, ties):
    cfg = GRAPHS[name]()
    params, state = seeded_params(cfg, seed=3, ties=ties)
    jgraph, graph = JaxGraph.from_cfg(cfg), Graph.from_cfg(cfg)
    if ratio == 'above-limit':
        limit = jax_prune_slimming(jgraph, params, state, 0.0).prune_limit
        ratio = min(limit + 0.03, 0.99)
    want = jax_prune_slimming(jgraph, params, state, ratio)
    p, s = from_jax_params(params, state, graph, device='cpu')
    got = prune_slimming(graph, p, s, ratio)
    assert got.cfg_text == want.cfg_text
    assert got.report == want.report
    assert got.prune_limit == want.prune_limit
    if ratio > want.prune_limit:
        assert 'cast to 16 channels' in got.report[1]
    gp, gs = to_jax_params(got.params, got.state, Graph.from_cfg(got.cfg_text))
    _assert_trees_equal(gp, jax.tree.map(np.asarray, want.params))
    _assert_trees_equal(gs, jax.tree.map(np.asarray, want.state))
    # the inputs are untouched
    assert all(torch.equal(p[k]['w'], torch.from_numpy(np.ascontiguousarray(
        params[k]['w'].transpose(3, 2, 0, 1)))) for k in p if 'bn' in p[k])


def test_prune_ties_keep_the_lower_index():
    """Under tied |gamma| the stable pick keeps the lower channel indices,
    as JAX's ``argsort(-|g|, kind='stable')``."""
    b = CfgBuilder()
    b.conv(32, size=3, stride=2)
    b.conv(3 * 8, size=1, bn=False, activation='linear')
    b.yolo(3)
    cfg = b.text()
    params, state = seeded_params(cfg)
    params['0']['bn']['gamma'] = np.concatenate(
        [np.full(20, 0.5), np.full(12, 0.25)]).astype(np.float32)[::-1].copy()
    graph = Graph.from_cfg(cfg)
    p, s = from_jax_params(params, state, graph, device='cpu')
    got = prune_slimming(graph, p, s, 0.5)   # threshold 0.5: 0 above, 16 kept
    kept = got.params['0']['bn']['gamma'].numpy()
    assert kept.shape == (16,) and (kept == 0.5).all()
    order = np.argsort(-np.abs(params['0']['bn']['gamma']), kind='stable')[:16]
    assert np.array_equal(got.params['0']['w'].numpy(), p['0']['w'].numpy()[np.sort(order)])


def test_prune_zeroed_channels_is_function_preserving():
    """Channels with gamma = beta = 0 contribute nothing; pruning them (ratio
    0.1 puts the threshold inside the zeroed gammas) leaves the port's f32
    forward as it was."""
    cfg = _mobile_style_cfg()
    net = DetectionNetwork.from_cfg(cfg)
    params, state = net.init(torch.Generator().manual_seed(1), device='cpu')
    rng = np.random.RandomState(0)
    for idx in ('0', '10'):
        gamma = params[idx]['bn']['gamma'].numpy().copy()
        beta = params[idx]['bn']['beta'].numpy().copy()
        kill = rng.permutation(len(gamma))[:len(gamma) // 3]
        gamma[kill] = 0.0
        beta[kill] = 0.0
        survivors = np.setdiff1d(np.arange(len(gamma)), kill)
        gamma[survivors] = np.sign(gamma[survivors] + 1e-3) * (np.abs(gamma[survivors]) + 1.0)
        params[idx]['bn'] = {'gamma': torch.from_numpy(gamma), 'beta': torch.from_numpy(beta)}
    x = torch.from_numpy(rng.rand(2, 32, 32, 3).astype(np.float32))
    with torch.no_grad():
        base = net(params, state, x)
        res = prune_slimming(net.graph, params, state, 0.1)
        out = DetectionNetwork.from_cfg(res.cfg_text)(res.params, res.state, x)
    assert res.cfg_text != cfg
    np.testing.assert_allclose(out.numpy(), base.numpy(), rtol=1e-4, atol=1e-4)


def test_pruned_forward_matches_jax():
    """The pruned mobilenetv2-fpn's f32 forward (BN on its running
    statistics) against JAX's on the same pruned params at 64 px: 1e-4
    relative to the preds' scale."""
    cfg = get_cfg('mobilenetv2-fpn')
    params, state = seeded_params(cfg, seed=5)
    want = jax_prune_slimming(JaxGraph.from_cfg(cfg), params, state, 0.3)
    graph = Graph.from_cfg(cfg)
    p, s = from_jax_params(params, state, graph, device='cpu')
    got = prune_slimming(graph, p, s, 0.3)
    x = np.random.RandomState(2).rand(2, 64, 64, 3).astype(np.float32)
    jnet = JaxNetwork.from_cfg(want.cfg_text)
    jout, _ = jax.jit(lambda pp, ss, xx: jnet.apply(pp, ss, xx))(
        jax.tree.map(jnp.asarray, want.params), jax.tree.map(jnp.asarray, want.state),
        jnp.asarray(x))
    with torch.no_grad():
        out = DetectionNetwork.from_cfg(got.cfg_text)(got.params, got.state,
                                                      torch.from_numpy(x))
    jout = np.asarray(jout)
    assert out.shape == jout.shape and np.isfinite(jout).all()
    err = np.abs(out.numpy() - jout).max()
    assert err <= 1e-4 * max(1.0, np.abs(jout).max()), err


def test_prune_rejects_grouped_nondepthwise():
    """A grouped conv that is not depthwise raises ValueError in both
    packages."""
    b = CfgBuilder()
    b.conv(32, size=3, stride=2)
    b.conv(32, size=3, groups=4)
    b.conv(3 * 8, size=1, bn=False, activation='linear')
    b.yolo(3)
    cfg = b.text()
    params, state = seeded_params(cfg)
    with pytest.raises(ValueError, match='only depthwise'):
        jax_prune_slimming(JaxGraph.from_cfg(cfg), params, state, 0.3)
    graph = Graph.from_cfg(cfg)
    p, s = from_jax_params(params, state, graph, device='cpu')
    with pytest.raises(ValueError, match='only depthwise'):
        prune_slimming(graph, p, s, 0.3)


def test_fused_chains_of_the_pruned_graph_match_jax():
    """``find_fused_triples`` picks JAX's chains on the pruned graph: the
    bare dw + pw pairs whose width is no longer a multiple of 128 drop
    out, so fewer than the 21 of the unpruned graph fuse."""
    cfg = pruned_mobilenetv2_cfg()
    got = find_fused_triples(Graph.from_cfg(cfg))
    assert got == jax_find_fused_triples(JaxGraph.from_cfg(cfg))
    assert len(got) < len(find_fused_triples(Graph.from_cfg(get_cfg('mobilenetv2-fpn'))))
    nodes = {n.index: n for n in Graph.from_cfg(cfg).nodes}
    assert any(nodes[b].in_channels % 16 == 8 for _, b, _ in got)


@pytest.mark.parametrize('size', [512, 320])
def test_count_macs_params_matches_jax(size):
    for cfg in (get_cfg('mobilenetv2-fpn'), pruned_mobilenetv2_cfg(), _mobile_style_cfg()):
        got = count_macs_params(Graph.from_cfg(cfg), (size, size))
        assert got == jax_count_macs_params(JaxGraph.from_cfg(cfg), (size, size))
        assert [clever_format(v) for v in got] == [jax_clever_format(v) for v in got]
    assert count_macs_params(Graph.from_cfg(get_cfg('mobilenetv2-fpn')), (512, 512)) == \
        (4_335_796_224, 6_775_393)
    macs, params = count_macs_params(Graph.from_cfg(pruned_mobilenetv2_cfg()), (512, 512))
    assert macs < 4_335_796_224 and params < 6_775_393


@pytest.mark.parametrize('n', [0, 999, 1000, 12_345, 4_335_796_224, 6_775_393, 1e6])
def test_clever_format_matches_jax(n):
    assert clever_format(n) == jax_clever_format(n)
