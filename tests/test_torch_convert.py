"""The port's darknet, checkpoint-surgery and reference-conversion
functions and its ``cli.convert`` modes against the JAX package's on the
CPU, from the same weights: darknet bytes, partial checkpoints and
converted reference checkpoints byte for byte (both packages write flax's
msgpack bytes of the same numpy trees, so byte equality is the strictest
check and holds), state dicts array for array, and each CLI mode's output
against the JAX CLI's from the same checkpoint.
"""

import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pqdet_tpu.cli import convert as jax_cli
from pqdet_tpu.compress.qat import QuantCtx as JaxQuantCtx
from pqdet_tpu.compress.qat import prepare_qat_state as jax_prepare_qat_state
from pqdet_tpu.compress.quantized import convert_to_int8 as jax_convert_to_int8
from pqdet_tpu.compress.quantized import save_quantized as jax_save_quantized
from pqdet_tpu.exporters.export import load_stablehlo as jax_load_stablehlo
from pqdet_tpu.exporters.export import partial_checkpoint as jax_partial_checkpoint
from pqdet_tpu.exporters.export import save_weights_darknet as jax_save_darknet
from pqdet_tpu.exporters.torch_convert import \
    convert_to_torch_state_dict as jax_to_torch_sd
from pqdet_tpu.exporters.torch_convert import convert_torch_state_dict as jax_from_torch_sd
from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
from pqdet_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from pqdet_tpu_torch.bridge import from_jax_params, to_jax_params
from pqdet_tpu_torch.cli import convert as cli
from pqdet_tpu_torch.exporters.export import (load_stablehlo, load_weights_darknet,
                                              partial_checkpoint, save_weights_darknet)
from pqdet_tpu_torch.exporters.torch_convert import (convert_to_torch_state_dict,
                                                     convert_torch_state_dict)
from pqdet_tpu_torch.model.network import DetectionNetwork
from tests.test_prune import _mobile_style_cfg

SIZE = 32


def _seeded_bn(params, state, seed=3):
    """JAX's init with seeded BN statistics and affine, so no array is all
    zeros or ones."""
    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, params)
    state = jax.tree.map(np.asarray, state)
    for k, p in params.items():
        if 'bn' in p:
            c = p['bn']['gamma'].shape[0]
            p['bn'] = {'gamma': (0.8 + 0.4 * rng.rand(c)).astype(np.float32),
                       'beta': (0.1 * rng.randn(c)).astype(np.float32)}
            state[k] = {'mean': (0.1 * rng.randn(c)).astype(np.float32),
                        'var': (0.8 + 0.4 * rng.rand(c)).astype(np.float32)}
    return params, state


@pytest.fixture(scope='module')
def model():
    cfg = _mobile_style_cfg()
    jnet = JaxNetwork.from_cfg(cfg)
    params, state = _seeded_bn(*jnet.init(jax.random.PRNGKey(0)))
    net = DetectionNetwork.from_cfg(cfg)
    return cfg, jnet, params, state, net


@pytest.fixture(scope='module')
def ckpts(model, tmp_path_factory):
    """A normal and a 'quant' checkpoint written by the JAX package."""
    cfg, jnet, params, state, _ = model
    d = tmp_path_factory.mktemp('ckpts')
    normal = str(d / 'fp.ckpt')
    jax_save_checkpoint(normal, params, state, step=7, cfg_text=cfg, ap=0.25)
    qnet = JaxNetwork.from_cfg(cfg, quant=True)
    qp, qs = jax_prepare_qat_state(qnet, params, state)
    x = jnp.asarray(np.random.RandomState(1).rand(1, SIZE, SIZE, 3), jnp.float32)
    ctx = JaxQuantCtx(qs['quant'], observing=True)
    qnet.apply(qp, qs, x, quant_ctx=ctx)
    jq = jax_convert_to_int8(qnet, qp, {**qs, 'quant': ctx.new_obs})
    quant = str(d / 'q.ckpt')
    jax_save_quantized(quant, qnet, jax.tree.map(np.asarray, jq), cfg, step=9)
    return normal, quant


def _reference_state_dict(graph, params, state, prefix):
    """A reference-style state_dict (OIHW torch tensors under
    ``module_list.N``) of JAX's (params, state)."""
    sd = {}
    for node in graph.nodes:
        i = str(node.index)
        if i not in params:
            continue
        base = f'{prefix}module_list.{node.index}'
        p = params[i]
        sd[f'{base}.conv.weight'] = torch.from_numpy(
            np.array(np.asarray(p['w']).transpose(3, 2, 0, 1)))
        if 'bn' in p:
            sd[f'{base}.bn.weight'] = torch.from_numpy(p['bn']['gamma'])
            sd[f'{base}.bn.bias'] = torch.from_numpy(p['bn']['beta'])
            sd[f'{base}.bn.running_mean'] = torch.from_numpy(state[i]['mean'])
            sd[f'{base}.bn.running_var'] = torch.from_numpy(state[i]['var'])
            sd[f'{base}.bn.num_batches_tracked'] = torch.tensor(5)
        else:
            sd[f'{base}.conv.bias'] = torch.from_numpy(np.array(p['b']))
    return sd


def _assert_trees_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_darknet_bytes_equal_jax_and_load_inverts(model, tmp_path):
    _, jnet, params, state, net = model
    jax_save_darknet(jnet, params, state, str(tmp_path / 'j.weights'), seen=11)
    tp, ts = from_jax_params(params, state, net.graph, device='cpu')
    save_weights_darknet(net, tp, ts, str(tmp_path / 'p.weights'), seen=11)
    assert (tmp_path / 'p.weights').read_bytes() == (tmp_path / 'j.weights').read_bytes()
    other = net.init(torch.Generator().manual_seed(9), device='cpu')
    lp, ls = load_weights_darknet(net, str(tmp_path / 'j.weights'), *other)
    jp, js = to_jax_params(lp, ls, net.graph)
    _assert_trees_equal(jp, params)
    _assert_trees_equal(js, state)
    with pytest.raises(ValueError, match='truncated'):
        (tmp_path / 'short.weights').write_bytes((tmp_path / 'j.weights').read_bytes()[:999])
        load_weights_darknet(net, str(tmp_path / 'short.weights'), *other)


@pytest.mark.parametrize('layers', [3, 9])
def test_partial_checkpoint_bytes_equal_jax(ckpts, tmp_path, layers):
    normal, _ = ckpts
    jax_partial_checkpoint(normal, str(tmp_path / 'j.ckpt'), layers)
    partial_checkpoint(normal, str(tmp_path / 'p.ckpt'), layers)
    assert (tmp_path / 'p.ckpt').read_bytes() == (tmp_path / 'j.ckpt').read_bytes()


@pytest.mark.parametrize('prefix', ['', 'module.'])
def test_state_dict_conversions_equal_jax(model, prefix):
    _, jnet, params, state, net = model
    sd = _reference_state_dict(net.graph, params, state, prefix)
    jp, js = jax_from_torch_sd(sd, jnet)
    tp, ts = convert_torch_state_dict(sd, net)
    assert all(t.device.type == 'cpu' for p in tp.values() for t in p.values()
               if isinstance(t, torch.Tensor))
    pj, sj = to_jax_params(tp, ts, net.graph)
    _assert_trees_equal(pj, jax.tree.map(np.asarray, jp))
    _assert_trees_equal(sj, jax.tree.map(np.asarray, js))
    _assert_trees_equal(convert_to_torch_state_dict(tp, ts, net),
                        jax_to_torch_sd(jp, js, jnet))


def _jax_cli(monkeypatch, argv):
    monkeypatch.setattr(sys, 'argv', ['convert', *argv])
    jax_cli.main()


@pytest.mark.parametrize('mode', ['onnx-fp', 'onnx-quant', 'darknet', 'partial',
                                  'from-torch'])
def test_cli_writes_the_jax_clis_bytes(ckpts, model, mode, tmp_path, monkeypatch):
    """Each mode of ``cli.convert`` (``--device cpu``, in process) writes the
    JAX CLI's bytes from the same input."""
    normal, quant = ckpts
    cfg, _, params, state, net = model
    weight = quant if mode == 'onnx-quant' else normal
    if mode == 'from-torch':
        weight = str(tmp_path / 'ref.pt')
        torch.save({'model': _reference_state_dict(net.graph, params, state, 'module.'),
                    'cfg': cfg, 'step': 4, 'type': 'normal'}, weight)
    args = [mode.split('-')[0] if mode != 'from-torch' else mode, '--weight', weight,
            '--size', str(SIZE), '--bs', '2', '--layers', '5']
    _jax_cli(monkeypatch, [*args, '--out', str(tmp_path / 'jax.out')])
    cli.main([*args, '--out', str(tmp_path / 'port.out'), '--device', 'cpu'])
    assert (tmp_path / 'port.out').read_bytes() == (tmp_path / 'jax.out').read_bytes()


@pytest.mark.parametrize('kind', ['fp', 'quant'])
def test_cli_stablehlo_computes_what_the_jax_artifact_computes(ckpts, kind, tmp_path,
                                                              monkeypatch):
    """``convert stablehlo`` writes a ``.pt2`` program where the JAX CLI
    writes StableHLO: the two compute the same function, fp to 1e-4 and
    the int8 ``'int'`` programs within tests/test_torch_int8.py's bounds
    for the two packages' int modes (scores 2e-2, boxes 0.5 px: XLA's
    contracted FMA flips a code now and then)."""
    weight = ckpts[0] if kind == 'fp' else ckpts[1]
    args = ['stablehlo', '--weight', weight, '--size', str(SIZE)]
    _jax_cli(monkeypatch, [*args, '--out', str(tmp_path / 'm.shlo')])
    cli.main([*args, '--out', str(tmp_path / 'm.pt2'), '--device', 'cpu'])
    x = np.random.RandomState(2).rand(1, SIZE, SIZE, 3).astype(np.float32)
    want = np.asarray(jax_load_stablehlo((tmp_path / 'm.shlo').read_bytes())(jnp.asarray(x)))
    with torch.inference_mode():
        got = load_stablehlo((tmp_path / 'm.pt2').read_bytes(), device='cpu')(
            torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    if kind == 'fp':
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got[..., 4:] - want[..., 4:]).max() <= 2e-2
        assert np.abs(got[..., :4] - want[..., :4]).max() <= 0.5
