"""The compression ladder through the port's CLIs on the CPU: fp train ->
sparse train -> slimming prune + a fine-tune epoch -> QAT on the pruned cfg
-> int8 convert -> int8 eval, the tiny detector of tests/test_e2e.py on the
VOC fixture at 64 px, with the assertions of tests/test_ladder_e2e.py
(checkpoint names and discovery across stages, ``model.cfg_path`` over the
cfg a pruned checkpoint embeds, the quant state machine taking a pruned
fine-tuned checkpoint). Across the packages: JAX's ``prune_slimming`` on
the sparse checkpoint as JAX reads it equals the port's raw
``-pruned.ckpt``, and each package's ``build_detector`` loads the other's
pruned checkpoint. Then the bench CLI's ``summary`` (JAX's line), ``time``
and ``benchmark`` modes."""

import glob
import os
import sys

import jax
import numpy as np
import pytest

from pqdet_tpu.cli import bench as jax_cli_bench
from pqdet_tpu.compress.prune import prune_slimming as jax_prune_slimming
from pqdet_tpu.model.factory import build_detector as jax_build_detector
from pqdet_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from pqdet_tpu_torch.bridge import to_jax_params
from pqdet_tpu_torch.cli import bench as cli_bench
from pqdet_tpu_torch.cli import convert as cli_convert
from pqdet_tpu_torch.cli import prune as cli_prune
from pqdet_tpu_torch.cli import train as cli_train
from pqdet_tpu_torch.model.factory import build_detector
from pqdet_tpu_torch.utils.codec import load_checkpoint
from test_torch_prune import _assert_trees_equal
from test_torch_trainer import _opts


def newest_ckpt(wdir, exp):
    """tools/run_ladder.py's discovery: the newest epoch's checkpoint of an
    experiment, never the raw ``-pruned.ckpt`` that cli.prune writes beside
    its input."""
    paths = [p for p in glob.glob(os.path.join(wdir, exp, '*.ckpt'))
             if not os.path.basename(p).endswith('-pruned.ckpt')]

    def key(p):
        parts = os.path.basename(p).rsplit('.', 1)[0].split('-')
        i = len(parts) - 1 - parts[::-1].index('model')
        return int(parts[i + 1])
    return max(paths, key=key)


@pytest.fixture(scope='module')
def ladder(tmp_path_factory):
    """Runs the ladder once; returns its paths and each stage's output."""
    tmp = tmp_path_factory.mktemp('ladder')
    wdir = str(tmp / 'weights')
    base = _opts(tmp, 4, 'train.max_epochs', '1', 'train.warmup_epochs', '0.0',
                 'eval.after', '99')
    outs = {}

    def run(mod, name, argv):
        from contextlib import redirect_stdout
        from io import StringIO
        buf = StringIO()
        with redirect_stdout(buf):
            mod.main(argv)
        outs[name] = buf.getvalue()
        sys.stdout.write(outs[name])

    run(cli_train, 'fp', ['--device', 'cpu'] + base + ['experiment_name', 'fp'])
    fp = newest_ckpt(wdir, 'fp')
    run(cli_train, 'sparse', ['--device', 'cpu'] + base + [
        'experiment_name', 'sparse', 'weight.resume', fp, 'weight.clear_history', 'on',
        'sparse.switch', 'on', 'sparse.ratio', '0.005'])
    sparse = newest_ckpt(wdir, 'sparse')
    new_cfg = str(tmp / 'pruned.cfg')
    run(cli_prune, 'prune', ['--device', 'cpu'] + base + [
        'experiment_name', 'pruneft', 'prune.weight', sparse, 'prune.new_cfg', new_cfg,
        'prune.ratio', '0.3', 'prune.finetune_epochs', '1'])
    pruneft = newest_ckpt(wdir, 'pruneft')
    run(cli_train, 'qat', ['--device', 'cpu'] + base + [
        'experiment_name', 'qat', 'weight.resume', pruneft, 'weight.clear_history', 'on',
        'model.cfg_path', new_cfg, 'quant.switch', 'on', 'quant.disable_observer_after', '0',
        'quant.freeze_bn_after', '1', 'eval.after', '0'])
    qat = newest_ckpt(wdir, 'qat')
    int8 = str(tmp / 'int8.ckpt')
    run(cli_convert, 'convert', ['quantize', '--weight', qat, '--out', int8, '--device', 'cpu'])
    run(cli_bench, 'eval', ['eval', '--weight', int8, '--device', 'cpu'] + base)
    return dict(tmp=tmp, wdir=wdir, base=base, fp=fp, sparse=sparse, new_cfg=new_cfg,
                pruneft=pruneft, qat=qat, int8=int8, outs=outs)


def test_ladder_through_the_port_clis(ladder):
    L = ladder
    assert os.path.basename(L['fp']) == 'model-0.ckpt'          # eval.after 99
    assert 'BN layers will be sparsed' in L['outs']['sparse']
    out = L['outs']['prune']
    assert 'prune limit' in out and 'Slimming Pruner done' in out and 'flops: ' in out
    assert 'mAPs' in out                                       # the pruned model's test
    assert os.path.exists(L['new_cfg'])
    # the raw pre-finetune checkpoint lands beside the sparse one and does
    # not win the sparse experiment's discovery
    raw = L['sparse'].rsplit('.', 1)[0] + '-pruned.ckpt'
    assert os.path.exists(raw)
    assert newest_ckpt(L['wdir'], 'sparse') == L['sparse']
    # run_prune evaluates every epoch: 'pruned-30-model-<e>-<AP>.ckpt'
    assert os.path.basename(L['pruneft']).startswith('pruned-30-model-0-')
    ft = load_checkpoint(L['pruneft'])
    with open(L['new_cfg']) as fr:
        assert ft['cfg'] == fr.read()
    assert ft['step'] == 2                                    # history cleared: 2 steps
    # QAT on the pruned cfg, its per-epoch int8 eval printed an AP table
    assert 'quantization aware training' in L['outs']['qat'] and 'mAPs' in L['outs']['qat']
    assert load_checkpoint(L['qat'])['type'] == 'qat'
    assert load_checkpoint(L['int8'])['type'] == 'quant'
    assert 'mAPs' in L['outs']['eval']


def test_prune_matches_jax_on_the_sparse_checkpoint(ladder):
    """JAX's prune_slimming on the sparse checkpoint, as JAX's
    build_detector reads it, equals the port's raw ``-pruned.ckpt``; each
    package's build_detector loads the other's pruned checkpoint."""
    jnet, jparams, jstate, _ = jax_build_detector(weight_path=ladder['sparse'])
    want = jax_prune_slimming(jnet.graph, jax.device_get(jparams), jax.device_get(jstate), 0.3)
    raw = ladder['sparse'].rsplit('.', 1)[0] + '-pruned.ckpt'
    got = load_checkpoint(raw)
    assert got['cfg'] == want.cfg_text and got['step'] == 0
    _assert_trees_equal(got['params'], jax.tree.map(np.asarray, want.params))
    _assert_trees_equal(got['state'], jax.tree.map(np.asarray, want.state))

    # JAX reads the port's file ...
    jnet2, jp2, js2, info = jax_build_detector(weight_path=raw)
    assert info['cfg_text'] == want.cfg_text
    _assert_trees_equal(jax.tree.map(np.asarray, jp2), jax.tree.map(np.asarray, want.params))
    # ... and the port reads JAX's
    jpath = str(ladder['tmp'] / 'jax-pruned.ckpt')
    jax_save_checkpoint(jpath, want.params, want.state, step=0, cfg_text=want.cfg_text)
    net, p, s, info = build_detector(weight_path=jpath, device='cpu')
    assert info['cfg_text'] == want.cfg_text
    tp, ts = to_jax_params(p, s, net.graph)
    _assert_trees_equal(tp, jax.tree.map(np.asarray, want.params))
    _assert_trees_equal(ts, jax.tree.map(np.asarray, want.state))


def test_bench_summary_time_benchmark(ladder, capsys, monkeypatch):
    """``summary`` prints JAX's line for the pruned cfg; ``time`` (f32 and
    bf16) and ``benchmark`` run the pruned fine-tuned checkpoint at 64 px."""
    for size in ('64', '512'):
        monkeypatch.setattr(sys, 'argv', ['bench', 'summary', '--cfg', ladder['new_cfg'],
                                          '--size', size])
        jax_cli_bench.main()
        want = capsys.readouterr().out.strip().splitlines()[-1]
        cli_bench.main(['summary', '--cfg', ladder['new_cfg'], '--size', size])
        assert capsys.readouterr().out.strip().splitlines()[-1] == want
        assert want.startswith('flops:') and ', params: ' in want

    for extra in ([], ['--bf16']):
        t = cli_bench.main(['time', '--weight', ladder['pruneft'], '--size', '64', '--bs', '2',
                            '--device', 'cpu'] + extra)
        out = capsys.readouterr().out
        assert 'bs=2 size=64' in out and 0 < t['p50'] <= t['p90']
    with pytest.raises(NotImplementedError, match='queue 1, item 10'):
        cli_bench.main(['time', '--shlo', 'm.shlo', '--device', 'cpu'])

    stats = cli_bench.main(['benchmark', '--weight', ladder['pruneft'], '--device', 'cpu']
                           + ladder['base'])
    out = capsys.readouterr().out
    for stage in ('total', 'forward', 'convert', 'nms'):
        assert f'{stage}: mean ' in out and stats[stage] > 0
    assert stats['total'] >= stats['forward']
