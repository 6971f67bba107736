"""The port's NAS and evolution drivers (``pqdet_tpu_torch/nas/search.py``,
``nas/evolute.py``, ``Trainer.run_nas``, ``cli/search.py``,
``cli/evolute.py``) against the JAX package's on the CPU: the hyper
sampler and round config, the injected loss hypers reaching the loss,
``run_nas`` on tests/test_drivers.py's tiny net and VOC fixture with JAX's
schedule, the logs of ``search`` and ``Evoluter.run`` on a stubbed trainer
(JAX's catch-all ``diverged`` and dropped failed rounds kept), the NaN
message, and both CLIs on the three shipped NAS and evolution yamls.
"""

import copy
import json
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import pqdet_tpu.train.trainer as jax_trainer_mod
from pqdet_tpu.cli import evolute as jax_cli_evolute
from pqdet_tpu.cli import search as jax_cli_search
from pqdet_tpu.config import load_config as jax_load_config
from pqdet_tpu.nas import evolute as jax_evolute
from pqdet_tpu.nas import search as jax_search
from pqdet_tpu.train.schedule import build_schedule as jax_build_schedule
import pqdet_tpu_torch.train.trainer as trainer_mod
from pqdet_tpu_torch.cli import evolute as cli_evolute
from pqdet_tpu_torch.cli import search as cli_search
from pqdet_tpu_torch.config import load_config
from pqdet_tpu_torch.model.decode import decode
from pqdet_tpu_torch.model.graph import Graph
from pqdet_tpu_torch.model.loss import loss_per_scale, sum_scale_losses
from pqdet_tpu_torch.model.network import TARGET_MAP, DetectionNetwork
from pqdet_tpu_torch.nas import evolute, search
from pqdet_tpu_torch.ops.labels import label_assigner_from_config
from pqdet_tpu_torch.train.trainer import Trainer
from test_data import _write_voc_fixture
from test_drivers import _tiny_cfg_text

REPO = Path(__file__).resolve().parent.parent
NAS_YAMLS = ('nas.yaml', 'nas_clutter.yaml', 'evolute_clutter.yaml')
NAN_ERROR = 'NaN in loss near step 88; head-input max|act| per scale, last finite rows []'


def _small_opts(tmp_path):
    """tests/test_drivers.py's ``small_cfg``: the 4-image VOC fixture at 64 px."""
    txt = _write_voc_fixture(str(tmp_path), n=4)
    return ['dataset.train_txt_file', txt, 'dataset.eval_txt_file', txt,
            'dataset.classes', '[cat, dog, bird]', 'model.max_gt_boxes', '8',
            'train.batch_size', '2', 'train.input_sizes', '[64]',
            'train.warmup_epochs', '0.5', 'eval.after', '0', 'eval.batch_size', '2',
            'eval.input_size', '64', 'eval.max_detections', '16',
            'weight.dir', str(tmp_path / 'w'), 'system.num_workers', '2',
            'system.compute_dtype', 'float32']


@pytest.mark.parametrize('seed', range(5))
def test_sample_hypers_equals_jax(seed):
    assert evolute.BASE_HYPERS == jax_evolute.BASE_HYPERS
    rng, jrng = np.random.RandomState(seed), np.random.RandomState(seed)
    hypers = [evolute.sample_hypers(rng) for _ in range(4)]
    assert hypers == [jax_evolute.sample_hypers(jrng) for _ in range(4)]
    assert set(evolute.LOSS_HYPERS) | {'hflip_p', 'crop_p', 'color_p', 'mixup_p'} \
        == set(evolute.BASE_HYPERS)


@pytest.mark.parametrize('yaml_name', NAS_YAMLS)
def test_round_config_equals_jax(yaml_name):
    """``Evoluter._round_config`` sets every key JAX's sets, to JAX's values,
    and leaves the base config as it was."""
    path = str(REPO / 'yamls' / yaml_name)
    cfg, jcfg = load_config(path), jax_load_config(path)
    before = copy.deepcopy(cfg)
    hypers = evolute.sample_hypers(np.random.RandomState(7))
    got = evolute.Evoluter(cfg, rounds=1, seed=0, device='cpu')._round_config(hypers)
    want = jax_evolute.Evoluter(jcfg, rounds=1, seed=0)._round_config(hypers)
    keys = [('augment', k) for k in ('hflip_p', 'crop_p', 'color_p', 'mixup_p')] + \
        [('train', 'max_epochs'), ('train', 'warmup_epochs'), ('train', 'scheduler'),
         ('eval', 'after')]
    for group, key in keys:
        assert getattr(getattr(got, group), key) == getattr(getattr(want, group), key), key
    assert got.augment.mixup_p == hypers['mixup_p'] and got.train.max_epochs == 1
    assert cfg == before


def _head_inputs(net, params, state, x):
    """The raw input of each yolo node (the output of the node before it)."""
    taps = {}
    net.forward_train(params, state, x, train=False,
                      tap=lambda i, y: taps.__setitem__(i, y.detach().clone()))
    return [(taps[n.index - 1], n) for n in net.graph.yolo_nodes]


def test_injected_loss_hypers_reach_the_loss(tmp_path):
    """After ``inject_loss_hypers`` the walk's loss equals the per-head
    ``loss_per_scale`` called with the hypers as kwargs on the same raw
    heads, summed as the step sums them, and differs from the loss before
    the injection."""
    cfg = load_config(opts=_small_opts(tmp_path))
    net = DetectionNetwork.from_cfg(_tiny_cfg_text())
    params, state = net.init(torch.Generator().manual_seed(0), device='cpu')
    gen = torch.Generator().manual_seed(1)
    x = torch.rand(2, 64, 64, 3, generator=gen)
    gt = torch.zeros(2, 8, 6)
    gt[:, :3, :2] = torch.rand(2, 3, 2, generator=gen) * 30
    gt[:, :3, 2:4] = gt[:, :3, :2] + 8 + torch.rand(2, 3, 2, generator=gen) * 25
    gt[:, :3, 4] = torch.randint(0, 3, (2, 3), generator=gen).float()
    gt[:, :3, 5] = 1.0
    targets = label_assigner_from_config(cfg, device='cpu')(gt, (64, 64))
    base, _ = net.forward_train(params, state, x, targets, train=False)
    hypers = evolute.sample_hypers(np.random.RandomState(3))
    evolute.inject_loss_hypers(net, hypers)
    got, _ = net.forward_train(params, state, x, targets, train=False)
    want = []
    for raw, node in _head_inputs(net, params, state, x):
        a = node.attrs
        assert all(a[k] == hypers[k] for k in evolute.LOSS_HYPERS)
        gi, bi = TARGET_MAP[a['stride']]
        want.append(loss_per_scale(
            decode(raw, a['classes'], a['stride'], exp_cap=a.get('exp_cap', 0.0)),
            targets[gi], targets[bi], stride=a['stride'], num_classes=a['classes'],
            bbox_loss_type=a['bbox_loss'], l1_loss_gain=a['l1_loss_gain'],
            **{k: hypers[k] for k in evolute.LOSS_HYPERS}))
    want = sum_scale_losses(want)
    assert sorted(got) == sorted(want)
    for k in ('loss', 'giou_loss', 'conf_loss', 'class_loss'):
        assert torch.equal(got[k], want[k]), k
        assert not torch.equal(got[k], base[k]), k
    assert all(torch.equal(g, w) for g, w in zip(got['loss_per_branch'],
                                                   want['loss_per_branch']))


def test_run_nas_returns_ap_with_jax_schedule(tmp_path, capsys):
    """``Trainer.run_nas`` on the tiny net: epochs 0..eval.after (here 0..1)
    then one eval, an AP in [0, 1], the device state released; its lr per
    step equals JAX's ``build_schedule`` on the config JAX's ``run_nas``
    leaves (warm-up 0.5 epochs; JAX's trainer stubbed, not trained)."""
    opts = _small_opts(tmp_path) + ['eval.after', '1', 'train.max_epochs', '4']
    trainer = Trainer(load_config(opts=opts), device='cpu')
    ap = trainer.run_nas(_tiny_cfg_text())
    assert 0.0 <= ap <= 1.0 and trainer.AP.AP == ap
    spe = trainer.steps_per_epoch
    assert spe == 2 and trainer.global_step == 2 * spe
    assert trainer.params is None and trainer.opt_state is None and trainer.step_fn is None
    assert '4 images for train' in capsys.readouterr().out

    jt = jax_trainer_mod.Trainer(jax_load_config(opts=opts))
    epochs = []
    jt.init_all = lambda: None
    jt.train_epoch = epochs.append
    jt.evaluate = lambda: types.SimpleNamespace(AP=0.5)
    jt.close = lambda: None
    assert jt.run_nas(_tiny_cfg_text()) == 0.5 and epochs == [0, 1]
    assert trainer.config.train.warmup_epochs == jt.config.train.warmup_epochs == 0.5
    jsched = jax_build_schedule(jt.config, spe)
    steps = range(trainer.config.train.max_epochs * spe + 2)
    # JAX computes in f32, the port in Python floats: 1e-7 of the initial lr
    np.testing.assert_allclose([trainer.schedule(k) for k in steps],
                               [float(jsched(k)) for k in steps], rtol=1e-6,
                               atol=1e-7 * trainer.config.train.learning_rate_init)
    assert trainer.schedule(0) == 0.0 and trainer.schedule(1) > 0.0


def test_run_nas_releases_a_failed_candidate(tmp_path, monkeypatch):
    """A candidate whose loss goes NaN mid-epoch: ``run_nas`` raises the NaN
    error, and its ``close`` has shut the epoch's loader (the generator
    left suspended by the exception) and dropped the device state."""
    trainer = Trainer(load_config(opts=_small_opts(tmp_path) + ['eval.after', '1']),
                      device='cpu')
    loaders = []
    epoch_batches = Trainer._epoch_batches

    def spy(self):
        loaders.append(epoch_batches(self))
        return loaders[-1]

    def nan(self, epoch, pending, final=False):
        raise RuntimeError(f'NaN in loss near step {self.global_step}')
    monkeypatch.setattr(Trainer, '_epoch_batches', spy)
    monkeypatch.setattr(Trainer, '_flush_metrics', nan)
    with pytest.raises(RuntimeError, match='near step 1$'):
        trainer.run_nas(_tiny_cfg_text())
    assert len(loaders) == 1 and loaders[0].gi_frame is None
    assert trainer._batches is None and trainer.params is None and trainer.step_fn is None


def test_trainer_nan_message_matches_jax_regex():
    """A non-finite loss raises with ``near step N``, the step the search
    logs as the step of death."""
    trainer = Trainer.__new__(Trainer)
    trainer.global_step = 37
    metrics = {k: torch.tensor([float('nan')]) for k in
               ('loss', 'giou_loss', 'conf_loss', 'class_loss')}
    metrics['loss_per_branch'] = torch.zeros(3)
    with pytest.raises(RuntimeError) as err:
        trainer._flush_metrics(0, [metrics], final=True)
    m = re.search(r'near step (\d+)', str(err.value))
    assert m and int(m.group(1)) == 37 and str(err.value).startswith('NaN in loss')


@pytest.mark.parametrize('logit', [15.0, 16.0, 17.0, 18.0, -104.0, -110.0])
@pytest.mark.parametrize('target', [0.0, 1.0])
def test_bce_gradient_at_a_saturated_score_as_jax(logit, target):
    """A candidate whose score logit reaches 17 (its sigmoid rounds to 1.0
    in f32; -104 rounds to 0.0) gets a NaN gradient from the BCE, whose -100
    log clamp passes a zero cotangent into log's infinite derivative: the
    JAX package's ``bce`` does the same (its docstring says grad 0), so
    such a candidate dies as ``NaN in loss`` on the next step in both. The
    port keeps it; below the saturation the gradients agree."""
    import jax
    import jax.numpy as jnp
    from pqdet_tpu.model.loss import bce as jax_bce
    from pqdet_tpu_torch.model.loss import bce
    jg = float(jax.grad(lambda z: jax_bce(jax.nn.sigmoid(z), target))(jnp.float32(logit)))
    z = torch.tensor(logit, requires_grad=True)
    bce(torch.sigmoid(z), torch.tensor(target)).backward()
    g = z.grad.item()
    saturated = abs(logit) >= 17
    assert np.isnan(g) == np.isnan(jg) == saturated
    if not saturated:
        np.testing.assert_allclose(g, jg, rtol=1e-6)


def _nas_stub():
    """A Trainer stand-in for ``search``: candidate 0 completes with AP 0.25,
    candidate 1 raises JAX's NaN error, candidate 2 another error, then
    APs again."""
    calls = []

    class Stub:
        def __init__(self, config, device=None):
            self.config = config

        def run_nas(self, cfg_text):
            calls.append(cfg_text)
            k = len(calls) - 1
            if k == 1:
                raise RuntimeError(NAN_ERROR)
            if k == 2:
                raise ValueError('planted failure: not a divergence')
            return 0.25 + 0.125 * k
    return Stub, calls


def _read(path):
    with open(path) as fr:
        return json.load(fr)


def test_search_log_equals_jax(tmp_path, monkeypatch):
    """``search`` on a stubbed trainer writes JAX's records: cfg, MACs,
    params, head, status, AP, step of death, error; ``meta`` apart from its
    driver, commit and date. A second search appends to the log."""
    opts = _small_opts(tmp_path)
    stub, calls = _nas_stub()
    jstub, jcalls = _nas_stub()
    monkeypatch.setattr(trainer_mod, 'Trainer', stub)
    monkeypatch.setattr(jax_trainer_mod, 'Trainer', jstub)
    log, jlog = str(tmp_path / 'port.json'), str(tmp_path / 'jax.json')
    recs = search.search(load_config(opts=opts), rounds=4, log_path=log, seed=0, device='cpu')
    jrecs = jax_search.search(jax_load_config(opts=opts), rounds=4, log_path=jlog, seed=0)
    assert recs == jrecs and calls == jcalls and len(calls) == 4
    got, want = _read(log), _read(jlog)
    assert got['data'] == want['data'] == recs
    assert [r['status'] for r in recs] == ['completed', 'diverged', 'diverged', 'completed']
    assert recs[1]['step_of_death'] == 88 and recs[2]['step_of_death'] is None
    assert recs[2]['error'] == 'planted failure: not a divergence'
    meta, jmeta = got['meta'], want['meta']
    assert meta['driver'] == 'pqdet_tpu_torch/nas/search.py'
    for k in ('driver', 'commit', 'date'):
        meta.pop(k), jmeta.pop(k)
    assert meta == jmeta
    search.search(load_config(opts=opts), rounds=1, log_path=log, seed=1, device='cpu')
    assert len(_read(log)['data']) == 5


def _evo_stub(fail_round=1):
    """A Trainer stand-in for ``Evoluter.run``: fitness from the injected
    yolo attrs and the round's augment config; round ``fail_round`` raises in
    its epoch."""
    rounds = []

    class Stub:
        def __init__(self, config, device=None):
            self.config = config
            rounds.append(config)

        def init_all(self):
            self.network = types.SimpleNamespace(graph=types.SimpleNamespace(
                yolo_nodes=[types.SimpleNamespace(attrs={'stride': s}) for s in (8, 16, 32)]))

        def train_epoch(self, epoch):
            assert epoch == 0
            if len(rounds) - 1 == fail_round:
                raise RuntimeError('NaN in loss near step 3')

        def evaluate(self):
            a = self.network.graph.yolo_nodes[0].attrs
            return types.SimpleNamespace(
                AP=(a['cls_loss_gain'] + a['ignore_thresh'] + self.config.augment.mixup_p) / 8)

        def close(self):
            self.closed = True
    return Stub, rounds


def test_evoluter_log_equals_jax(tmp_path, monkeypatch):
    """``Evoluter.run`` on a stubbed trainer: JAX's records (hypers and
    fitness; the failed round dropped from the log, as JAX drops it) and
    exit block; telemetry carries the card's allocated bytes where JAX's
    counts live arrays."""
    opts = _small_opts(tmp_path)
    stub, rounds = _evo_stub()
    jstub, jrounds = _evo_stub()
    monkeypatch.setattr(evolute, 'Trainer', stub)
    monkeypatch.setattr(jax_evolute, 'Trainer', jstub)
    log, jlog = str(tmp_path / 'evo.json'), str(tmp_path / 'jevo.json')
    recs = evolute.Evoluter(load_config(opts=opts), rounds=3, log_path=log, seed=0,
                            device='cpu').run()
    jrecs = jax_evolute.Evoluter(jax_load_config(opts=opts), rounds=3, log_path=jlog,
                                 seed=0).run()
    assert len(rounds) == len(jrounds) == 3 and len(recs) == len(jrecs) == 2
    got, want = _read(log), _read(jlog)
    assert got['exit'] == want['exit'] == {'status': 'completed', 'completed_rounds': 2,
                                           'target_rounds': 3}
    assert set(got['data'][0]['telemetry']) == {'rss_gb', 'cuda_allocated', 'gc_objects'}
    assert got['data'][0]['telemetry']['cuda_allocated'] == 0
    assert set(want['data'][0]['telemetry']) == {'rss_gb', 'live_arrays', 'gc_objects'}
    strip = [[{k: v for k, v in r.items() if k != 'telemetry'} for r in d['data']]
             for d in (got, want)]
    assert strip[0] == strip[1]
    assert strip[0][0]['hyper'] != strip[0][1]['hyper']
    assert all(0.0 <= r['fitness'] <= 1.0 for r in recs)


@pytest.mark.parametrize('cli,jax_cli', [(cli_search, jax_cli_search),
                                         (cli_evolute, jax_cli_evolute)])
def test_cli_help_has_jax_flags(cli, jax_cli, capsys, monkeypatch):
    """Each CLI takes JAX's flags, ``--device`` and ``--dist-backend`` (its
    ranks' collective backend); the evolution CLIs enable ``faulthandler``
    first (recorded here: pytest's stderr has no fileno)."""
    enabled = []
    monkeypatch.setattr('faulthandler.enable', lambda *a, **k: enabled.append(1))

    def flags(call):
        with pytest.raises(SystemExit) as exit_:
            call()
        assert exit_.value.code == 0
        return set(re.findall(r'(--[a-z][a-z-]*)', capsys.readouterr().out))
    got = flags(lambda: cli.main(['--help']))
    monkeypatch.setattr('sys.argv', ['prog', '--help'])
    want = flags(jax_cli.main)
    assert got == want | {'--device', '--dist-backend'}
    assert len(enabled) == (2 if cli is cli_evolute else 0)


@pytest.mark.parametrize('yaml_name', NAS_YAMLS)
def test_shipped_nas_yamls_drive_their_cli(yaml_name, tmp_path, monkeypatch, capsys):
    """The three shipped NAS and evolution yamls load in the port, and their
    CLI runs one round on them with ``--device cpu`` (the trainer
    stubbed): a search record for nas.yaml and nas_clutter.yaml, an
    evolution record for evolute_clutter.yaml."""
    path = str(REPO / 'yamls' / yaml_name)
    cfg = load_config(path)
    assert cfg.dataset.classes and cfg.eval.after >= 0
    log = str(tmp_path / 'log.json')
    if yaml_name.startswith('nas'):
        stub, calls = _nas_stub()
        monkeypatch.setattr(trainer_mod, 'Trainer', stub)
        recs = cli_search.main(['--yaml', path, '--rounds', '1', '--seed', '0', '--log', log,
                                '--device', 'cpu', 'train.max_epochs', '2'])
        assert len(calls) == 1 and recs[0]['status'] == 'completed'
        assert Graph.from_cfg(recs[0]['cfg']).yolo_nodes[0].attrs['classes'] == \
            len(cfg.dataset.classes)
        assert 'candidate 0: completed' in capsys.readouterr().out
    else:
        stub, rounds = _evo_stub(fail_round=-1)
        monkeypatch.setattr(evolute, 'Trainer', stub)
        recs = cli_evolute.main(['--yaml', path, '--rounds', '1', '--seed', '0', '--log', log,
                                 '--device', 'cpu'])
        assert len(recs) == 1 and rounds[0].train.max_epochs == 1
        assert rounds[0].model.cfg_path == 'mobilenetv2-fpn'
    assert _read(log)['data'] == recs
