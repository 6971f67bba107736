"""The QAT arc of the port on the CPU, against the JAX package: the tiny
detector of tests/test_e2e.py on the VOC fixture, resumed from one
JAX-written fp checkpoint into the quant graph by both trainers with
``quant.switch`` on, two epochs of two steps (f32, no augmentation) with
the phase flip between them (epoch 0 observes with batch statistics,
epoch 1 freezes the observers and BN), each trainer's int8 eval after
epoch 1, and the qat checkpoints each writes. Then the same trainer's eval
on the same params and observers (the port's plain int8 versions against
JAX's Pallas kernels in interpret mode), qat and quant checkpoints read
across both ways, and the CLI arc ``cli.train`` (QAT) -> ``cli.convert
quantize`` -> ``cli.bench eval``."""

import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from pqdet_tpu.compress.quantized import load_quantized as jax_load_quantized
from pqdet_tpu.compress.quantized import save_quantized as jax_save_quantized
from pqdet_tpu.compress.quantized import convert_to_int8 as jax_convert_to_int8
from pqdet_tpu.config import load_config as jax_load_config
from pqdet_tpu.exporters.onnx_export import \
    export_quantized_to_onnx as jax_export_quantized_to_onnx
from pqdet_tpu.model.factory import build_detector as jax_build_detector
from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
from pqdet_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from pqdet_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from pqdet_tpu.train.trainer import Trainer as JaxTrainer
from pqdet_tpu_torch.bridge import from_jax_params, from_jax_qparams, to_jax_params
from pqdet_tpu_torch.cli import bench as cli_bench
from pqdet_tpu_torch.cli import convert as cli_convert
from pqdet_tpu_torch.cli import train as cli_train
from pqdet_tpu_torch.compress.quantized import convert_to_int8, load_quantized, save_quantized
from pqdet_tpu_torch.config import load_config
from pqdet_tpu_torch.model.factory import build_detector
from pqdet_tpu_torch.train.step import tree_leaves
from pqdet_tpu_torch.train.trainer import Trainer
from pqdet_tpu_torch.utils.codec import dumps, load_checkpoint
from test_e2e import TINY_DET
from test_torch_trainer import _opts

LR = 1e-3


def _qat_opts(tmp_path, *extra):
    return _opts(tmp_path, 4, 'system.compute_dtype', 'float32', 'augment.mixup_p', '0',
                 'augment.hflip_p', '0', 'augment.crop_p', '0', 'augment.color_p', '0',
                 'train.warmup_epochs', '0', 'train.learning_rate_init', str(LR),
                 'quant.switch', 'on', 'quant.disable_observer_after', '1',
                 'quant.freeze_bn_after', '1', *extra)


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp('qat')
    jnet = JaxNetwork.from_cfg(TINY_DET)
    params, state = jax.device_get(jnet.init(jax.random.PRNGKey(5)))
    path = str(tmp_path / 'start.ckpt')
    jax_save_checkpoint(path, params, state, step=0, cfg_text=TINY_DET)
    opts = _qat_opts(tmp_path, 'weight.resume', path)

    jt = JaxTrainer(jax_load_config(opts=opts + ['experiment_name', 'jax']))
    jlosses, jflags = [], []
    jt.init_all()
    jstep = jt._make_jstep

    def jmake():
        step = jstep()

        def record(*args):
            out = step(*args)
            jlosses.append(float(out[3]['loss']))
            jflags.append((jt._observing, jt._bn_frozen))
            return out
        return record
    jt._make_jstep = jmake
    jt.jstep = jmake()
    jt.train()

    pt = Trainer(load_config(opts=opts + ['experiment_name', 'port']), device='cpu')
    plosses, pflags = [], []
    pt.init_all()
    make = pt._make_step

    def pmake():
        step, opt = make()

        def record(*args):
            out = step(*args)
            plosses.append(float(out[3]['loss']))
            pflags.append((pt._observing, pt._bn_frozen))
            return out
        return record, opt
    pt._make_step = pmake
    pt.step_fn = pmake()[0]
    pt.train()
    return dict(tmp=tmp_path, jt=jt, pt=pt, jlosses=jlosses, plosses=plosses, jflags=jflags,
                pflags=pflags, start=(params, state), opts=opts)


def _flat_np(tree, prefix=''):
    if isinstance(tree, dict):
        return {k2: v2 for k in sorted(tree)
                for k2, v2 in _flat_np(tree[k], f'{prefix}/{k}').items()}
    return {prefix: np.asarray(tree)}


def _assert_trees_equal(a, b):
    """The same keys, and at each the same dtype, shape and values."""
    fa, fb = _flat_np(a), _flat_np(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def _assert_port_equal(a, b):
    """Two of the port's nested dicts: the same keys, tensors equal."""
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _assert_port_equal(a[k], b[k])
    else:
        assert a.dtype == b.dtype and torch.equal(a, b)


def _jax_state_in_port(jt, graph):
    return from_jax_params(jax.device_get(jt.params), jax.device_get(jt.state), graph,
                           device='cpu')


def test_qat_losses_and_phases_match_jax(runs):
    """Every step's loss within rtol 1e-5 of JAX's (measured 1.3e-7), in the
    same phases: epoch 0 observes with batch statistics, epoch 1 freezes
    both (the step rebuilt at the flip)."""
    phases = [(True, False)] * 2 + [(False, True)] * 2
    assert runs['pflags'] == runs['jflags'] == phases
    np.testing.assert_allclose(runs['plosses'], runs['jlosses'], rtol=1e-5)


def test_qat_observers_and_params_match_jax(runs):
    """After the two epochs: every observer within 1e-6 of max(1, |v|) of
    JAX's and initialised, BN statistics within 1e-5, and the params within
    1e-2 LR of JAX's where JAX moved them by at least 0.1 LR (the rest
    within 2 LR), the bounds of tests/test_torch_trainer.py."""
    jt, pt = runs['jt'], runs['pt']
    wp, ws = _jax_state_in_port(jt, pt.network.graph)
    assert sorted(pt.state['quant']) == sorted(ws['quant'])
    for edge, o in ws['quant'].items():
        got = pt.state['quant'][edge]
        assert bool(got['initialized']) and bool(o['initialized'])
        for k in ('min', 'max'):
            assert abs(float(got[k]) - float(o[k])) <= 1e-6 * max(1.0, abs(float(o[k]))), edge
    for key in ws:
        if key != 'quant':
            for st in ('mean', 'var'):
                a, w = pt.state[key][st], ws[key][st]
                assert ((a - w).abs() <= 1e-5 * w.abs().clamp_min(1.0)).all(), (key, st)
    start = torch.cat([t.reshape(-1) for t in tree_leaves(
        from_jax_params(*runs['start'], pt.network.graph, device='cpu')[0])])
    want = torch.cat([t.reshape(-1) for t in tree_leaves(wp)])
    got = torch.cat([t.reshape(-1) for t in tree_leaves(pt.params)])
    real = (want - start).abs() >= 0.1 * LR
    d = (got - want).abs()
    assert real.sum() > 0.5 * real.numel()
    assert d[real].max() <= 1e-2 * LR, d[real].max().item()
    assert d.max() <= 2 * LR


def test_qat_eval_matches_jax_on_the_same_params(runs):
    """The trainer's int8 eval (convert, then Int8Inference in kernel mode,
    the plain versions on the CPU) against JAX's (pallas mode, its kernels
    in interpret mode) on JAX's params and observers after the run: the
    same number of detections per image, the same classes, boxes and scores
    within 1e-3 (measured 3e-5), and the same AP from both trainers' own
    evals after epoch 1."""
    jt, pt = runs['jt'], runs['pt']
    assert pt.AP.AP == pytest.approx(jt.AP.AP, abs=1e-6)
    own = pt.params, pt.state
    pt.params, pt.state = _jax_state_in_port(jt, pt.network.graph)
    jpred, ppred = jt.make_predict_fn(), pt.make_predict_fn()
    pt.params, pt.state = own
    n = 0
    for jb, pb in zip(jt.eval_data.batches(1), pt.eval_data.batches(1)):
        for a, b in zip(jpred(jb), ppred(pb)):
            assert a.shape == b.shape and len(a) > 0
            np.testing.assert_array_equal(b[:, 5], a[:, 5])
            np.testing.assert_allclose(b[:, :5], a[:, :5], rtol=0, atol=1e-3)
            n += 1
    assert n == 4


def test_qat_and_quant_checkpoints_cross_both_ways(runs):
    """Each trainer's last qat checkpoint loads in the other package's
    ``build_detector`` bit for bit (params, BN statistics, observers with
    their 0-d bool flags), and its bytes are flax's; the quant checkpoint
    of each package's conversion loads in the other's ``load_quantized`` bit
    for bit."""
    tmp, jt, pt = runs['tmp'], runs['jt'], runs['pt']

    def last(name):
        d = tmp / 'weights' / name
        return str(d / sorted(f for f in os.listdir(d) if f.startswith('model-1-'))[0])
    jpath, ppath = last('jax'), last('port')
    for path in (jpath, ppath):
        blob = open(path, 'rb').read()
        assert blob == serialization.msgpack_serialize(jax_load_checkpoint(path)) \
            == dumps(load_checkpoint(path))
        assert load_checkpoint(path)['type'] == 'qat'

    _, p, s, info = build_detector(weight_path=jpath, device='cpu')
    wp, ws = _jax_state_in_port(jt, pt.network.graph)
    assert info['type'] == 'qat' and info['step'] == 4
    _assert_port_equal(p, wp)
    _assert_port_equal(s, ws)
    _, jp, js, jinfo = jax_build_detector(weight_path=ppath)
    assert jinfo['type'] == 'qat'
    tp, ts = to_jax_params(pt.params, pt.state, pt.network.graph)
    _assert_trees_equal(jp, tp)
    _assert_trees_equal(js, ts)
    assert js['quant']['input']['initialized'].dtype == np.bool_

    qpath = str(tmp / 'port-int8.ckpt')
    qparams = convert_to_int8(pt.network, pt.params, pt.state)
    save_quantized(qpath, pt.network, qparams, pt.cfg_text, step=4)
    _, jq = jax_load_quantized(qpath)
    assert open(qpath, 'rb').read() == serialization.msgpack_serialize(
        jax_load_checkpoint(qpath))
    _, back = load_quantized(qpath, device='cpu')
    _assert_port_equal(back['layers'], qparams['layers'])
    assert back['act'] == qparams['act'] == jq['act']
    _assert_port_equal(from_jax_qparams(jq, pt.network.graph, device='cpu')['layers'],
                       qparams['layers'])

    jpath_q = str(tmp / 'jax-int8.ckpt')
    jparams, jstate = jax.device_get((jt.params, jt.state))
    jqp = jax_convert_to_int8(jt.network, jparams, jstate)
    jax_save_quantized(jpath_q, jt.network, jqp, TINY_DET, step=4)
    _, pq = load_quantized(jpath_q, device='cpu')
    _assert_port_equal(pq['layers'], from_jax_qparams(jqp, pt.network.graph,
                                                      device='cpu')['layers'])
    assert pq['act'] == {k: (float(v[0]), float(v[1])) for k, v in jqp['act'].items()}


def test_qat_cli_arc(tmp_path, capsys):
    """``cli.train`` (QAT, resuming an fp checkpoint, eval every epoch)
    -> ``cli.convert quantize`` -> ``cli.bench eval``, in-process on the CPU:
    JAX's ``build_detector`` loads the qat checkpoint and its
    ``load_quantized`` the quant file; the quant file holds the qparams
    the trainer's eval converted in memory bit for bit, so the bench's AP
    (its table and its exact value) is the trainer's last; the exact
    integer mode evaluates too; then ``convert onnx`` writes the JAX
    writer's bytes of the quant file, and ``convert stablehlo`` a program
    that ``bench time --shlo`` times."""
    jnet = JaxNetwork.from_cfg(TINY_DET)
    params, state = jax.device_get(jnet.init(jax.random.PRNGKey(7)))
    start = str(tmp_path / 'fp.ckpt')
    jax_save_checkpoint(start, params, state, step=6, cfg_text=TINY_DET)
    opts = _opts(tmp_path, 4, 'weight.resume', start, 'weight.clear_history', 'on',
                 'quant.switch', 'on', 'quant.disable_observer_after', '1',
                 'quant.freeze_bn_after', '1', 'eval.after', '0', 'experiment_name', 'qat')
    cli_train.main(['--device', 'cpu'] + opts)
    out = capsys.readouterr().out
    assert 'quantization aware training' in out and out.count('mAPs') == 2
    wdir = tmp_path / 'weights' / 'qat'
    names = sorted(os.listdir(wdir))
    assert [n.split('-')[1] for n in names] == ['0', '1']
    qat = str(wdir / names[-1])
    ckpt = load_checkpoint(qat)
    assert (ckpt['type'], ckpt['backend'], ckpt['step']) == ('qat', 'int8', 4)
    jax_build_detector(weight_path=qat)

    int8 = str(tmp_path / 'int8.ckpt')
    cli_convert.main(['quantize', '--weight', qat, '--out', int8, '--device', 'cpu'])
    assert f'saved: {int8}' in capsys.readouterr().out
    jnet_q, jq = jax_load_quantized(int8)
    assert load_checkpoint(int8)['type'] == 'quant' and len(jq['layers']) == 8
    net, p, s, _ = build_detector(weight_path=qat, device='cpu')
    mem = convert_to_int8(net, p, s)
    _, loaded = load_quantized(int8, device='cpu')
    _assert_port_equal(loaded['layers'], mem['layers'])
    assert loaded['act'] == mem['act']

    ap = cli_bench.main(['eval', '--weight', int8, '--device', 'cpu'] + opts)
    out = capsys.readouterr().out
    assert 'mAPs' in out and f'AP {ap.AP!r}' in out
    assert ap.AP == ckpt['AP']
    exact = cli_bench.main(['eval', '--weight', int8, '--device', 'cpu', '--int8-exact'] + opts)
    assert 0.0 <= exact.AP <= 1.0
    # the arc's last steps: the quant file as ONNX (the JAX writer's bytes)
    # and as an exported program that bench time --shlo times
    onnx = tmp_path / 'm.onnx'
    cli_convert.main(['onnx', '--weight', int8, '--out', str(onnx), '--size', '64',
                      '--device', 'cpu'])
    assert onnx.read_bytes() == jax_export_quantized_to_onnx(jnet_q, jq, (64, 64))
    shlo = str(tmp_path / 'm.pt2')
    cli_convert.main(['stablehlo', '--weight', int8, '--out', shlo, '--size', '64',
                      '--device', 'cpu'])
    capsys.readouterr()
    t = cli_bench.main(['time', '--shlo', shlo, '--size', '64', '--device', 'cpu'])
    assert capsys.readouterr().out.startswith('stablehlo: ') and 0 < t['p50'] <= t['p90']
