"""The port's Trainer on the CPU: whole epochs of a tiny detector on the VOC
fixture of tests/test_e2e.py (eval, checkpoints both packages read,
resume with the step and the lr schedule restored), and one epoch against
the JAX Trainer from one JAX-written checkpoint (f32, no augmentation):
step 1's loss to 1e-5 relative, the params after the epoch within 1e-2 of
an lr of JAX's on the elements a real gradient moved."""

import os

import jax
import numpy as np
import pytest
import torch

from pqdet_tpu.config import load_config as jax_load_config
from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
from pqdet_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from pqdet_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from pqdet_tpu.train.trainer import Trainer as JaxTrainer
from pqdet_tpu_torch.bridge import from_jax_params
from pqdet_tpu_torch.config import load_config
from pqdet_tpu_torch.data.train_data import make_batch
from pqdet_tpu_torch.train.checkpoint import load_checkpoint, load_weights_into
from pqdet_tpu_torch.train.step import tree_leaves
from pqdet_tpu_torch.train.trainer import Trainer
from test_data import _write_voc_fixture
from test_e2e import TINY_DET

LR = 1e-3


def _opts(tmp_path, n=4, *extra):
    txt = _write_voc_fixture(str(tmp_path), n=n)
    cfg_file = tmp_path / 'tiny.cfg'
    cfg_file.write_text(TINY_DET)
    return ['dataset.train_txt_file', txt, 'dataset.eval_txt_file', txt,
            'dataset.classes', '[cat, dog, bird]', 'model.cfg_path', str(cfg_file),
            'model.max_gt_boxes', '8', 'train.batch_size', '2', 'train.input_sizes', '[64]',
            'train.max_epochs', '2', 'train.warmup_epochs', '1', 'eval.after', '1',
            'eval.batch_size', '2', 'eval.input_size', '64', 'eval.max_detections', '32',
            'weight.dir', str(tmp_path / 'weights'), 'system.num_workers', '2', *extra]


def test_trainer_end_to_end_and_resume(tmp_path, capsys):
    """Two epochs (eval after epoch 1), two checkpoints JAX reads, then a
    third epoch resumed from the epoch-1 checkpoint: step 4, the schedule
    at 4 with Adam's count and moments fresh, the checkpoint's weights, and
    the batches the uninterrupted run would have drawn in its third epoch."""
    opts = _opts(tmp_path)
    trainer = Trainer(load_config(opts=opts), device='cpu')
    trainer.run()
    out = capsys.readouterr().out
    assert '4 images for train' in out and 'mAPs' in out and 'train_loss' in out
    assert trainer.global_step == 4 and 0.0 <= trainer.AP.AP <= 1.0
    wdir = tmp_path / 'weights' / 'VOC'
    names = sorted(os.listdir(wdir))
    assert names == ['model-0.ckpt', f'model-1-{trainer.AP.AP:.4f}.ckpt']
    ckpt = jax_load_checkpoint(str(wdir / names[1]))
    assert ckpt['step'] == 4 and ckpt['cfg'] == TINY_DET and ckpt['AP'] == trainer.AP.AP
    assert jax_load_checkpoint(str(wdir / names[0]))['step'] == 2

    resumed = Trainer(load_config(opts=opts + ['train.max_epochs', '3', 'weight.resume',
                                               str(wdir / names[1])]), device='cpu')
    resumed.init_all()
    assert 'resumed at 4 steps' in capsys.readouterr().out
    o = resumed.opt_state
    assert (resumed.global_step, resumed.init_epoch, o['schedule_count'], o['count']) == \
        (4, 2, 4, 0)
    assert not o['mu'].any() and not o['nu'].any()
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed.params),
                                                 tree_leaves(trainer.params)))
    # the resumed epoch's plan and augment draws are the uninterrupted run's
    # epoch 2 (the first trainer has planned it after its last epoch)
    rd, td = resumed.train_data, trainer.train_data
    assert rd._epoch == td._epoch == 2
    assert (rd._indexes, rd._sizes) == (td._indexes, td._sizes)
    for idx in rd.batch_indices():
        rb, tb = make_batch(rd, idx), make_batch(td, idx)
        assert all(np.array_equal(rb[k], tb[k]) for k in ('image', 'gt'))
    resumed.train()
    assert resumed.global_step == 6 and resumed.opt_state['schedule_count'] == 6
    assert resumed.opt_state['count'] == 2
    assert any(n.startswith('model-2-') for n in os.listdir(wdir))
    last = load_checkpoint(str(wdir / [n for n in os.listdir(wdir)
                                       if n.startswith('model-2-')][0]))
    lp, ls = load_weights_into(resumed.network.graph, resumed.params, resumed.state, last)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(lp) + tree_leaves(ls),
                                                 tree_leaves(resumed.params)
                                                 + tree_leaves(resumed.state)))


def test_nan_loss_raises(tmp_path):
    trainer = Trainer(load_config(opts=_opts(tmp_path)), device='cpu')
    trainer.init_all()
    m = {'loss': torch.tensor(float('nan')), 'giou_loss': torch.tensor(0.0),
         'conf_loss': torch.tensor(0.0), 'class_loss': torch.tensor(0.0),
         'loss_per_branch': torch.zeros(3), 'head_max': torch.tensor([1.0, 90.0, 3.0])}
    ok = {**m, 'loss': torch.tensor(1.0)}
    with pytest.raises(RuntimeError, match='NaN in loss.*first non-finite step -1/2'):
        trainer._flush_metrics(0, [ok, m])
    m['head_max'] = torch.tensor([1.0, float('inf'), 3.0])
    with pytest.raises(RuntimeError, match='NaN in loss.*first non-finite step 1/2'):
        trainer._flush_metrics(0, [ok, m])


@pytest.mark.parametrize('key,value,item', [('train.unroll_steps', 'on', 'item 2'),
                                            ('system.loader', 'process', None)],
                         ids=['train.unroll_steps-item 2', 'system.loader-item 3'])
def test_queued_options_raise(tmp_path, key, value, item):
    """train.unroll_steps is still queued and raises naming its item;
    system.loader, queued until the process loader was ported, now starts
    the pool in init_all, and close ends it."""
    if item is not None:
        with pytest.raises(NotImplementedError, match=f'queue 1, {item}'):
            Trainer(load_config(opts=_opts(tmp_path, 4, key, value)), device='cpu').init_all()
        return
    trainer = Trainer(load_config(opts=_opts(tmp_path, 4, key, value)), device='cpu')
    trainer.init_all()
    pool = trainer._proc_loader._pool
    assert len(pool._pool) == 2
    trainer.close()
    assert trainer._proc_loader is None and all(not p.is_alive() for p in pool._pool)


def test_one_epoch_matches_jax_trainer(tmp_path):
    """Both trainers resume one JAX-written checkpoint (step 0) and run one
    epoch of two steps (f32, every augment probability 0, lr 0 then LR):
    the loss of each step rtol 1e-5; the params after the epoch within
    1e-2 LR of JAX's where JAX moved them by at least 0.1 LR (the rest, whose
    gradient is near Adam's eps, within 2 LR)."""
    opts = _opts(tmp_path, 4, 'system.compute_dtype', 'float32', 'augment.mixup_p', '0',
                 'augment.hflip_p', '0', 'augment.crop_p', '0', 'augment.color_p', '0',
                 'train.warmup_epochs', '0', 'train.learning_rate_init', str(LR),
                 'train.max_epochs', '1')
    jnet = JaxNetwork.from_cfg(TINY_DET)
    params, state = jax.device_get(jnet.init(jax.random.PRNGKey(5)))
    path = str(tmp_path / 'start.ckpt')
    jax_save_checkpoint(path, params, state, step=0, cfg_text=TINY_DET)
    opts += ['weight.resume', path]

    jt = JaxTrainer(jax_load_config(opts=opts))
    jt.init_all()
    jlosses = []
    jstep = jt.jstep

    def jrecord(*args):
        out = jstep(*args)
        jlosses.append(float(out[3]['loss']))
        return out
    jt.jstep = jrecord
    jt.train_epoch(0)

    pt = Trainer(load_config(opts=opts), device='cpu')
    pt.init_all()
    plosses = []
    pstep = pt.step_fn

    def precord(*args):
        out = pstep(*args)
        plosses.append(float(out[3]['loss']))
        return out
    pt.step_fn = precord
    pt.train_epoch(0)

    assert len(plosses) == len(jlosses) == 2 and pt.global_step == jt.global_step == 2
    np.testing.assert_allclose(plosses, jlosses, rtol=1e-5)
    start = torch.cat([t.reshape(-1) for t in tree_leaves(
        from_jax_params(params, state, pt.network.graph, device='cpu')[0])])
    want = torch.cat([t.reshape(-1) for t in tree_leaves(from_jax_params(
        jax.device_get(jt.params), jax.device_get(jt.state), pt.network.graph,
        device='cpu')[0])])
    got = torch.cat([t.reshape(-1) for t in tree_leaves(pt.params)])
    real = (want - start).abs() >= 0.1 * LR
    d = (got - want).abs()
    assert real.sum() > 0.5 * real.numel()
    assert d[real].max() <= 1e-2 * LR, d[real].max().item()
    assert d.max() <= 2 * LR
