"""The port's process loader and upload thread on the CPU: a ProcessLoader of
two spawned workers gives the thread loader's batches bit for bit (device
and host labels, two epochs), an abandoned epoch returns its slabs, the
Trainer's close ends the pool and unlinks the slabs, and the
device_prefetch thread gives the synchronous epoch's losses and stops
when its consumer abandons the epoch. A few 64-96 px images keep each
pool's spawn to seconds."""

import os
import threading

import numpy as np
import pytest
import torch

from pqdet_tpu_torch.config import load_config
from pqdet_tpu_torch.data.train_data import ProcessLoader, TrainData, epoch_batches
from pqdet_tpu_torch.train.trainer import Trainer
from test_data import _write_voc_fixture
from test_torch_trainer import _opts as trainer_opts


@pytest.fixture(scope='module')
def voc(tmp_path_factory):
    return _write_voc_fixture(str(tmp_path_factory.mktemp('voc')), n=6)


def _cfg(txt, *extra):
    return load_config(opts=['dataset.train_txt_file', txt, 'dataset.eval_txt_file', txt,
                             'dataset.classes', '[cat, dog, bird]', 'train.batch_size', '2',
                             'train.input_sizes', '[64, 96]', 'model.max_gt_boxes', '16',
                             'augment.mixup_p', '0.5', 'augment.mosaic_p', '0.5',
                             'augment.color_p', '0.5', 'system.loader', 'process', *extra])


def _assert_same_batches(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in g:
            a, b = (g[k], w[k]) if isinstance(g[k], tuple) else ((g[k],), (w[k],))
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)


def _unlinked(names):
    return all(not os.path.exists(os.path.join('/dev/shm', n)) for n in names)


@pytest.mark.parametrize('labels', ['device', 'host'])
def test_epochs_equal_thread_loader(voc, labels):
    """Two epochs through the pool equal the thread loader's on the same
    plan, bit for bit (each sample draws from its slot's generator in
    either); an epoch abandoned after one batch returns its slabs, and the
    next epoch still runs; close unlinks every slab."""
    data = TrainData(_cfg(voc, 'system.label_assign', labels))
    loader = ProcessLoader(data, num_workers=2, prefetch=2)
    names = loader.slab_names
    try:
        for _ in range(2):
            got = list(loader.epoch())
            _assert_same_batches(got, list(epoch_batches(data, num_workers=2)))
            data.init_shuffle()
        assert sorted(loader._free) == sorted(names)
        it = loader.epoch()
        next(it)
        it.close()
        assert sorted(loader._free) == sorted(names)
        _assert_same_batches(list(loader.epoch()), list(epoch_batches(data, num_workers=2)))
    finally:
        loader.close()
    assert len(names) == 4 and _unlinked(names)


def _trainer(tmp_path, *extra):
    opts = trainer_opts(tmp_path, 4, 'train.max_epochs', '1', 'eval.after', '5',
                        'system.compute_dtype', 'float32', *extra)
    trainer = Trainer(load_config(opts=opts), device='cpu')
    trainer.init_all()
    losses = []
    step = trainer.step_fn

    def probe(params, state, opt_state, batch, rng=None):
        out = step(params, state, opt_state, batch, rng)
        losses.append(float(out[3]['loss']))
        return out
    trainer.step_fn = probe
    return trainer, losses


def test_trainer_process_prefetch_epoch_and_close(tmp_path):
    """An epoch with the process loader, host labels and device_prefetch 2
    gives the losses of the synchronous thread-loader epoch; Trainer.close
    ends the pool's workers and unlinks its slabs."""
    sync, want = _trainer(tmp_path / 'sync', 'system.label_assign', 'host')
    sync.train_epoch(0)
    sync.close()
    trainer, got = _trainer(tmp_path / 'proc', 'system.label_assign', 'host', 'system.loader',
                            'process', 'system.device_prefetch', '2')
    workers = list(trainer._proc_loader._pool._pool)
    names = trainer._proc_loader.slab_names
    trainer.train_epoch(0)
    assert len(got) == len(want) == 2 and all(np.isfinite(got))
    assert got == want
    trainer.close()
    assert trainer._proc_loader is None and all(not w.is_alive() for w in workers)
    assert _unlinked(names)


def test_prefetch_stops_when_abandoned(tmp_path):
    """The upload thread of an epoch abandoned after its first batch: close
    sets the stop event, drains the queue, joins the thread (no
    device-prefetch thread left) and closes the host loader; a new epoch
    then runs whole."""
    trainer, _ = _trainer(tmp_path, 'system.device_prefetch', '1')
    before = {t.ident for t in threading.enumerate() if t.name == 'device-prefetch'}
    trainer._batches = trainer._epoch_batches()
    first = next(trainer._batches)
    assert first['image'].dtype == torch.uint8
    assert any(t.name == 'device-prefetch' for t in threading.enumerate())
    trainer.close()
    after = {t.ident for t in threading.enumerate() if t.name == 'device-prefetch'}
    assert after <= before
    trainer2, losses = _trainer(tmp_path / 'again', 'system.device_prefetch', '1')
    trainer2.train_epoch(0)
    assert len(losses) == 2 and all(np.isfinite(losses))
    trainer2.close()
