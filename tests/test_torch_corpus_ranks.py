"""The device corpus across ranks and the NAS-across-ranks gate's planted
faults, on the CPU (two gloo ranks, one spawn: ``ranks``, module scope).

- ``dataset.device_cache`` with ``augment.fresh_partners on`` at two ranks
  (JAX replicates the corpus over its mesh): each rank gathers its rows of
  the global batch and all of the global batch's fresh partner rows; the
  ranks' augmented rows, partner rows and first loss are one process's.
- ``chip_smoke.nas_ranks_agree`` (what NAS candidates and evolution rounds
  trained across ranks, against one process) on one evolution round of
  the tiny net, run as it should and with a planted fault: the grads left
  unaveraged (each rank steps on its own rows), or rank 1's rows dropped
  (it loads rank 0's). The gate passes on the first and fails on each
  fault, as ``tests/test_torch_int8.py::test_modes_conv_gate_catches_planted_faults``
  holds the int8 gate.

The rank side of this module imports no JAX.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from pqdet_tpu_torch.config import load_config
from pqdet_tpu_torch.data.train_data import TrainData
from pqdet_tpu_torch.nas.evolute import Evoluter
from pqdet_tpu_torch.ops.augment_device import augmenter_from_config
from pqdet_tpu_torch.parallel import mesh
from pqdet_tpu_torch.train import step as step_mod
from pqdet_tpu_torch.train.trainer import Trainer

W, B, SIZE = 2, 4, 64
FAULTS = (None, 'grads not averaged', 'rank 1 rows dropped')


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small CPU ops: beside the
    suite's other workers, an op split over all cores waits at its barrier
    for threads those workers hold (a 64 px int8 walk of
    ``test_kernel_mode_plain_flag_and_launches`` took 0.2 s alone and 35 s
    beside five busy processes, 0.8 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _opts(root):
    return ['dataset.train_txt_file', f'{root}/list.txt', 'dataset.eval_txt_file',
            f'{root}/list.txt', 'dataset.classes', '[cat, dog, bird]',
            'model.cfg_path', f'{root}/tiny.cfg', 'model.max_gt_boxes', '8',
            'train.batch_size', str(B), 'train.input_sizes', f'[{SIZE}]',
            'train.max_epochs', '1', 'train.warmup_epochs', '0.5', 'eval.after', '0',
            'eval.batch_size', '2', 'eval.input_size', str(SIZE), 'eval.max_detections', '16',
            'weight.dir', f'{root}/w', 'system.num_workers', '1',
            'system.compute_dtype', 'float32', 'system.data_devices', str(W)]


def _corpus_opts(root):
    return _opts(root) + ['augment.device', 'on', 'dataset.device_cache', 'on',
                          'augment.fresh_partners', 'on', 'augment.mosaic_p', '0.5',
                          'augment.mixup_p', '0.5', 'augment.hflip_p', '0.5',
                          'augment.crop_p', '0.5', 'augment.color_p', '0.5']


def _corpus_first_step(root, dev='cpu'):
    """The device corpus's first batch on this rank (its rows, the fresh
    partner rows, the device-augmented normalized image and GT of this
    rank's rows) and the loss of the first step on it."""
    cfg = load_config(opts=_corpus_opts(root))
    t = Trainer(cfg, device=dev)
    t.init_all()
    batches = t._epoch_batches()
    batch = next(batches)
    batches.close()
    batch['draws'] = t._draws(batch, 1)
    image, gt = step_mod._inputs(batch, lambda g, size: g, augmenter_from_config(cfg),
                                 mesh.active_group())
    loss = float(t.step_fn(t.params, t.state, t.opt_state, batch, t._rng)[3]['loss'])
    out = {'rows': batch['image'].clone(), 'partner_image': batch['partner_image'].clone(),
           'partner_gt': batch['partner_gt'].clone(), 'image': image, 'gt': gt, 'loss': loss,
           'n_data': t._n_data, 'corpus': t._device_cache['img'].shape[0]}
    t.close()
    return out


def _evolve(root, tag, reverse=False):
    """One evolution round of seed 0 on the tiny net; what it trained
    (``chip_smoke.trained_probe``)."""
    trained = []
    restore = chip_smoke.trained_probe(trained)
    flip = chip_smoke.reversed_rows() if reverse else (lambda: None)
    try:
        Evoluter(load_config(opts=_opts(root)), rounds=1, log_path=f'{root}/evo_{tag}.json',
                 seed=0, device='cpu').run()
    finally:
        flip()
        restore()
    return trained


def _planted(fault, r):
    """Plant ``fault`` on rank ``r``; returns the function that removes it."""
    if fault == 'grads not averaged':
        average = step_mod.average_grads
        step_mod.average_grads = lambda grads, group, shards: grads

        def restore():
            step_mod.average_grads = average
        return restore
    if fault == 'rank 1 rows dropped' and r == 1:
        indices = TrainData.batch_indices

        def rank0_rows(self):
            host, self._host_id = self._host_id, 0
            try:
                return indices(self)
            finally:
                self._host_id = host
        TrainData.batch_indices = rank0_rows

        def restore():
            TrainData.batch_indices = indices
        return restore
    return lambda: None


def _rank_work(dev, root):
    r = mesh.rank()
    res = {'corpus': _corpus_first_step(root, dev), 'evolve': {}}
    for fault in FAULTS:
        restore = _planted(fault, r)
        try:
            res['evolve'][fault] = _evolve(root, f'ranks_{fault}')
        finally:
            restore()
    torch.save(res, os.path.join(root, f'rank{r}.pt'))


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    from test_data import _write_voc_fixture
    from test_e2e import TINY_DET
    root = str(tmp_path_factory.mktemp('corpus_ranks'))
    txt = _write_voc_fixture(root, n=8)
    os.replace(txt, os.path.join(root, 'list.txt'))
    with open(os.path.join(root, 'tiny.cfg'), 'w') as fw:
        fw.write(TINY_DET)
    mesh.launch(_rank_work, W, 'cpu', 'gloo', (root,), timeout_s=300)
    return [torch.load(os.path.join(root, f'rank{r}.pt'), weights_only=False)
            for r in range(W)], root


def test_device_corpus_with_fresh_partners_at_two_ranks(ranks):
    """Each rank holds the whole corpus (8 images) and loads 2 of each
    global batch of 4; both gather the global batch's 16 fresh partner rows
    (3 mosaic + 1 mixup per image), one process's partner rows; the ranks'
    augmented rows and GT are one process's rows bit for bit, and the first
    loss (all-reduced) is one process's within 1e-5."""
    rs, root = ranks
    one = _corpus_first_step(root)
    lb = B // W
    assert one['n_data'] == 1 and one['partner_image'].shape[0] == 4 * B
    assert not torch.equal(one['image'][0], one['image'][1])
    for r, res in enumerate(rs):
        c = res['corpus']
        assert c['n_data'] == W and c['corpus'] == one['corpus'] == 8
        assert torch.equal(c['rows'], one['rows'][r * lb:(r + 1) * lb])
        assert torch.equal(c['partner_image'], one['partner_image'])
        assert torch.equal(c['partner_gt'], one['partner_gt'])
        assert torch.equal(c['image'], one['image'][r * lb:(r + 1) * lb])
        assert torch.equal(c['gt'], one['gt'][r * lb:(r + 1) * lb])
        assert abs(c['loss'] - one['loss']) <= 1e-5 * abs(one['loss'])
    assert rs[0]['corpus']['loss'] == rs[1]['corpus']['loss']


@pytest.fixture(scope='module')
def one_process(ranks):
    """One process's evolution round, and the same on its rows reversed."""
    _, root = ranks
    return _evolve(root, 'one'), _evolve(root, 'reversed', reverse=True)


@pytest.mark.parametrize('fault', FAULTS)
def test_nas_ranks_gate_catches_planted_faults(ranks, one_process, fault):
    """``nas_ranks_agree`` passes on what the two ranks trained in an
    evolution round and fails when a fault is planted on them; the reading
    (steps, first-loss relative difference, params distance, the one
    process's reversed-row drift; pooled) is printed."""
    rs, _ = ranks
    one, rev = one_process
    ok, rows, pooled = chip_smoke.nas_ranks_agree(rs[0]['evolve'][fault], one, rev)
    print(f'{fault}: {rows}, pooled {pooled}')
    assert len(one) == len(rs[0]['evolve'][fault]) == 1
    assert ok == (fault is None), (fault, rows, pooled)
    if fault is None:
        assert np.isfinite(pooled[1]) and pooled[1] > 0
