"""The port's device corpus and its trainer paths against the JAX package,
on the CPU: the cache built from the VOC fixture of tests/test_data.py
(decoded and letterboxed once at the largest input size) equal to the JAX
trainer's bit for bit; the gather with its bilinear resize to a smaller
size against ``jax.image.resize(..., antialias=False)``; the fresh
partner rows of an epoch equal to JAX's ``RandomState(system.seed + 7)``
draws; whole epochs of the port's trainer with device augmentation (with
and without the cache, fp and QAT), a resume that draws what the
uninterrupted run drew; the config checks; synth_clutter's corpus.

The resize: ``jax.image.resize`` renormalises its triangle kernel and
contracts both axes in one einsum (its summation order depends on the
shapes), ``F.interpolate`` lerps each axis, so they round a pixel to
another level where its value sits within an ulp of a half. At a ratio
of 3/4 every fourth output row and column lies exactly halfway between two
source pixels, where the blend is an exact tie whenever the two sum to an
odd number. At most RESIZE_SHARE of the pixels may be one level apart; the
share is printed (measured here: 1.6e-3 at 64 -> 48, at most 3.7e-4 at the
shipped ratios 416, 448 and 480 over 512 and their 64-px analogues)."""

import filecmp
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqdet_tpu.config import load_config as jax_load_config
from pqdet_tpu.data.scripts.synth_clutter import generate as jax_generate
from pqdet_tpu.data.train_data import TrainData as JaxTrainData
from pqdet_tpu.train.trainer import Trainer as JaxTrainer
from pqdet_tpu_torch.config import load_config
from pqdet_tpu_torch.data.scripts.synth_clutter import generate
from pqdet_tpu_torch.data.train_data import TrainData
from pqdet_tpu_torch.train.checkpoint import load_checkpoint
from pqdet_tpu_torch.train.trainer import Trainer
from test_torch_trainer import _opts

RESIZE_SHARE = 2e-3
AUG = ['augment.device', 'on', 'augment.mosaic_p', '0.5', 'augment.mixup_p', '0.5',
       'augment.color_p', '0.5', 'augment.vflip_p', '0.5', 'train.input_sizes', '[48, 56, 64]',
       'system.seed', '3']


def _jax_stub(cfg):
    """What JAX's cache methods read of their Trainer."""
    stub = types.SimpleNamespace(
        config=cfg, train_data=JaxTrainData(cfg), _device_cache=None, _augment_fn=object(),
        _data_sh=jax.sharding.SingleDeviceSharding(jax.devices()[0]))
    stub._cache_gather = lambda s: JaxTrainer._cache_gather(stub, s)
    return stub


@pytest.fixture(scope='module')
def corpus(tmp_path_factory):
    """Both packages' caches and one epoch of cached batches on the same
    config (6 images, sizes 48-64, fresh partners, seed 3), with each
    side's gathered rows recorded."""
    tmp = tmp_path_factory.mktemp('cache')
    opts = _opts(tmp, 6, *AUG, 'dataset.device_cache', 'on', 'train.batch_size', '3')
    js = _jax_stub(jax_load_config(opts=opts))
    JaxTrainer._build_device_cache(js)
    jrows, gather = [], js._cache_gather

    def jgather(s):
        fn = gather(s)

        def call(img, gt, idx):
            jrows.append((s, np.asarray(idx).tolist()))
            return fn(img, gt, idx)
        return call
    js._cache_gather = jgather
    jbatches = [jax.device_get(b) for b, _ in JaxTrainer._cached_batches(js)]

    trainer = Trainer(load_config(opts=opts), device='cpu')
    trainer.train_data = TrainData(trainer.config)
    trainer._build_device_cache()
    prows, pgather = [], trainer._cache_gather

    def record(size, idx):
        prows.append((size, idx.tolist()))
        return pgather(size, idx)
    trainer._cache_gather = record
    pbatches = list(trainer._cached_batches())
    return {'jax': js, 'port': trainer, 'jrows': jrows, 'prows': prows,
            'jbatches': jbatches, 'pbatches': pbatches}


def test_device_cache_matches_jax(corpus):
    """The cache: every train image letterboxed at 64 and its padded GT rows
    (weight column 1), bit for bit; 6 images, their size in GiB."""
    jc, trainer = corpus['jax']._device_cache, corpus['port']
    pc = trainer._device_cache
    assert pc['smax'] == jc['smax'] == 64 and pc['img'].dtype == torch.uint8
    np.testing.assert_array_equal(pc['img'].numpy(), np.asarray(jc['img']))
    np.testing.assert_array_equal(pc['gt'].numpy(), np.asarray(jc['gt']))
    valid = pc['gt'][..., 2] > pc['gt'][..., 0]
    assert valid.any() and (pc['gt'][..., 5][valid] == 1).all()
    assert trainer.cache_info['images'] == 6
    assert trainer.cache_info['gib'] == 6 * 64 * 64 * 3 / 2 ** 30


def test_partner_indices_match_jax(corpus):
    """An epoch's gathers: the plan's rows at the plan's sizes, then 4B
    fresh partner rows each, the same rows as JAX's, from
    ``RandomState(system.seed + 7)``; the batches' partner rows (and each
    whole batch at the largest size) equal JAX's."""
    jrows, prows = corpus['jrows'], corpus['prows']
    assert prows == jrows and len(prows) == 2 * len(corpus['pbatches'])
    want = np.random.RandomState(3 + 7).randint(0, 6, size=4 * 3)
    assert prows[1][1] == want.tolist()
    for jb, pb in zip(corpus['jbatches'], corpus['pbatches']):
        assert set(pb) == {'image', 'gt', 'partner_image', 'partner_gt'}
        assert pb['partner_image'].shape[0] == 4 * pb['image'].shape[0]
        np.testing.assert_array_equal(pb['partner_gt'].numpy(), jb['partner_gt'])
        if pb['image'].shape[1] == 64:
            for k in ('image', 'gt', 'partner_image'):
                np.testing.assert_array_equal(pb[k].numpy(), jb[k])


@pytest.mark.parametrize('smax,size', [(64, 48), (64, 52), (64, 56), (64, 60), (64, 64),
                                       (512, 416), (512, 448), (512, 480)])
def test_cache_gather_matches_jax(smax, size):
    """The gather of rows [3, 0, 5, 5] of a random corpus at ``size``:
    boxes bit for bit, images within one level on at most RESIZE_SHARE of
    the pixels (equal at the cache's own size)."""
    rng = np.random.default_rng(size)
    img = rng.integers(0, 256, (6, smax, smax, 3)).astype(np.uint8)
    gt = rng.uniform(0, smax, (6, 8, 6)).astype(np.float32)
    idx = np.array([3, 0, 5, 5])
    js = types.SimpleNamespace(_device_cache={'smax': smax, 'gather': {}},
                               _data_sh=jax.sharding.SingleDeviceSharding(jax.devices()[0]))
    want = JaxTrainer._cache_gather(js, size)(jnp.asarray(img), jnp.asarray(gt),
                                              jnp.asarray(idx, jnp.int32))
    ps = types.SimpleNamespace(_device_cache={'img': torch.from_numpy(img),
                                              'gt': torch.from_numpy(gt), 'smax': smax})
    got = Trainer._cache_gather(ps, size, torch.from_numpy(idx))
    assert got['image'].shape == (4, size, size, 3) and got['image'].dtype == torch.uint8
    np.testing.assert_array_equal(got['gt'].numpy(), np.asarray(want['gt']))
    d = np.abs(got['image'].numpy().astype(int) - np.asarray(want['image']).astype(int))
    print(f'{smax} -> {size}: {(d > 0).mean():.3g} of the pixels one level apart')
    assert d.max() <= 1 and (d > 0).mean() <= RESIZE_SHARE
    if size == smax:
        assert not d.any()


def _recording(trainer, log):
    """Record each step's batch (images, GT, the draws) after init_all."""
    step = trainer.step_fn

    def rec(params, state, opt_state, batch, rng=None):
        log.append({k: (v.clone() if isinstance(v, torch.Tensor) else v)
                    for k, v in batch.items()})
        return step(params, state, opt_state, batch, rng)
    trainer.step_fn = rec


@pytest.mark.parametrize('cache', ['off', 'on'])
def test_trainer_device_augment_and_resume(tmp_path, cache, capsys):
    """Two epochs of the tiny detector with every stage of the device chain
    on (in-batch partners without the cache, fresh ones with it): finite
    losses, AP after epoch 1, checkpoints; then a run resumed from the
    epoch-0 checkpoint draws and gathers what the uninterrupted run did in
    epoch 1 (draws seeded from (system.seed, global_step))."""
    opts = _opts(tmp_path, 4, *AUG, 'dataset.device_cache', cache, 'train.input_sizes', '[32, 64]')
    first = Trainer(load_config(opts=opts), device='cpu')
    first.init_all()
    log = []
    _recording(first, log)
    first.train()
    out = capsys.readouterr().out
    assert 'train_loss' in out and 'mAPs' in out and 0.0 <= first.AP.AP <= 1.0
    assert ('device cache built: 4 images at 64px' in out) == (cache == 'on')
    assert all(torch.isfinite(first.params[k]['w']).all() for k in first.params
               if 'w' in first.params[k])
    assert (first._partner_rows, 'partner_image' in log[0]) == \
        ((4, True) if cache == 'on' else (0, False))
    assert [b['draws'].hflip.shape[0] for b in log] == [2 * (5 if cache == 'on' else 1)] * 4

    wdir = tmp_path / 'weights' / 'VOC'
    resumed = Trainer(load_config(opts=opts + ['weight.resume', str(wdir / 'model-0.ckpt')]),
                      device='cpu')
    resumed.init_all()
    rlog = []
    _recording(resumed, rlog)
    resumed.train()
    assert resumed.global_step == 4 and len(rlog) == 2
    for a, b in zip(rlog, log[2:]):
        assert a.keys() == b.keys()
        for k in a:
            if k == 'draws':
                assert all(torch.equal(getattr(a[k], f), getattr(b[k], f)) for f in vars(a[k]))
            else:
                assert torch.equal(a[k], b[k]), k


def test_qat_trainer_with_device_augment(tmp_path):
    """One QAT epoch of the tiny detector's quant graph with the device
    chain and the cache (fresh partners): finite losses and a qat
    checkpoint."""
    opts = _opts(tmp_path, 4, *AUG, 'dataset.device_cache', 'on', 'quant.switch', 'on',
                 'train.max_epochs', '1', 'eval.after', '1', 'train.input_sizes', '[32, 64]')
    trainer = Trainer(load_config(opts=opts), device='cpu')
    trainer.init_all()
    losses = []
    step = trainer.step_fn

    def rec(*args):
        out = step(*args)
        losses.append(float(out[3]['loss']))
        return out
    trainer.step_fn = rec
    trainer.train()
    assert len(losses) == 2 and all(np.isfinite(losses))
    ckpt = load_checkpoint(str(tmp_path / 'weights' / 'VOC' / 'model-0.ckpt'))
    assert ckpt['type'] == 'qat' and ckpt['step'] == 2


@pytest.mark.parametrize('extra,error', [
    (['augment.fresh_partners', 'on'], 'set dataset.device_cache on'),
    (['dataset.device_cache', 'on'], 'needs augment.device=on'),
    (['augment.device', 'on', 'system.label_assign', 'host'], "needs system.label_assign"),
])
def test_device_options_checked(tmp_path, extra, error):
    """The JAX trainer's checks: fresh partners need the cache, the cache
    needs the device chain, the device chain needs device labels."""
    opts = _opts(tmp_path, 4, *extra)
    with pytest.raises(ValueError, match=error):
        Trainer(load_config(opts=opts), device='cpu').init_all()
    with pytest.raises(ValueError, match=error):
        JaxTrainer(jax_load_config(opts=opts)).init_all()


def test_synth_clutter_matches_jax(tmp_path):
    """synth_clutter with n=4 at 96 px writes JAX's files byte for byte."""
    jax_generate(str(tmp_path / 'jax'), n=4, size=96, seed=1)
    generate(str(tmp_path / 'port'), n=4, size=96, seed=1)
    for sub in ('JPEGImages', 'Annotations'):
        files = sorted(os.listdir(tmp_path / 'jax' / sub))
        assert files == sorted(os.listdir(tmp_path / 'port' / sub)) and len(files) == 4
        _, bad, err = filecmp.cmpfiles(tmp_path / 'jax' / sub, tmp_path / 'port' / sub, files,
                                       shallow=False)
        assert not bad and not err
    for split in ('train.txt', 'test.txt'):
        want = (tmp_path / 'jax' / split).read_text().replace('/jax/', '/port/')
        assert (tmp_path / 'port' / split).read_text() == want
