"""The port's differential evaluation (``pqdet_tpu_torch/cli/diffeval.py``):
its greedy detection matcher against the JAX package's, and, where the
torch reference tree is present (PQDET_REFERENCE), the port's whole eval
pipeline against the reference's on a briefly trained model, as
tests/test_diffeval.py runs JAX's."""

import os

import numpy as np
import pytest

from pqdet_tpu.cli.diffeval import _match_detections as jax_match
from pqdet_tpu_torch.cli.diffeval import _match_detections


def _dets(rng, n, classes=3):
    xy = rng.rand(n, 2) * 100
    return np.concatenate([xy, xy + 5 + rng.rand(n, 2) * 30, rng.rand(n, 1),
                           rng.randint(0, classes, (n, 1))], 1).astype(np.float32)


@pytest.mark.parametrize('seed', [0, 1, 2, 3])
def test_match_detections_equals_jax(seed):
    """Near copies (boxes within a pixel, scores within 1e-3, some over),
    dropped and extra rows, on both sides."""
    rng = np.random.RandomState(seed)
    a = _dets(rng, 30)
    b = a[rng.permutation(30)[:24]].copy()
    b[:, :4] += rng.uniform(-1.2, 1.2, (24, 4)).astype(np.float32)
    b[:, 4] += rng.uniform(-2e-3, 2e-3, 24).astype(np.float32)
    b = np.concatenate([b, _dets(rng, 5)])
    got = _match_detections(a, b)
    assert got == jax_match(a, b)
    assert _match_detections(b, a) == jax_match(b, a)
    assert sum(got[:2]) == len(a) and got[0] + got[2] == len(b)


def test_match_detections_empty_sides():
    a = _dets(np.random.RandomState(7), 4)
    empty = np.zeros((0, 6), np.float32)
    for x, y in ((a, empty), (empty, a), (empty, empty)):
        assert _match_detections(x, y) == jax_match(x, y)


def test_diffeval_small(tmp_path):
    """The port's pipeline against the reference's on synth_shapes after a
    few CPU epochs (the reference tree is needed; it is skipped without
    it, as tests/test_diffeval.py is)."""
    ref = os.environ.get('PQDET_REFERENCE', '')
    if not os.path.isdir(ref):
        pytest.skip('reference tree not mounted (set PQDET_REFERENCE)')
    from pqdet_tpu_torch.cli.diffeval import run_diffeval
    from pqdet_tpu_torch.config import load_config
    from pqdet_tpu_torch.data.scripts.synth_shapes import generate
    from pqdet_tpu_torch.train.trainer import Trainer
    from pqdet_tpu_torch.zoo.builder import CfgBuilder

    generate(str(tmp_path), n=16, size=224, seed=3, holdout=0.5)
    nc = 3
    b = CfgBuilder()
    b.conv(16, size=3, stride=2, activation='relu6')
    b.conv(16, size=3, groups=16, activation='relu6')
    b.conv(24, size=3, stride=2, activation='leaky')
    c = b.conv(24, size=1, activation='linear')
    b.conv(24, size=3, activation='relu6')
    b.shortcut(c)
    b.conv(32, size=3, stride=2, activation='relu6')
    b.conv(3 * (5 + nc), size=1, bn=False, activation='linear')
    b.yolo(nc)                                   # stride 8
    cfg_file = tmp_path / 'm.cfg'
    cfg_file.write_text(b.text())
    cfg = load_config(opts=[
        'dataset.name', 'VOC', 'dataset.train_txt_file', str(tmp_path / 'train.txt'),
        'dataset.eval_txt_file', str(tmp_path / 'test.txt'),
        'dataset.classes', '[square, circle, triangle]', 'model.cfg_path', str(cfg_file),
        'model.max_gt_boxes', '8', 'train.batch_size', '4', 'train.input_sizes', '[224]',
        'train.max_epochs', '8', 'train.warmup_epochs', '1',
        'train.learning_rate_init', '1e-3', 'eval.after', '99', 'eval.input_size', '224',
        'eval.batch_size', '4', 'eval.score_threshold', '0.3',
        'eval.max_detections', '3072', 'eval.pool_factor', '4', 'system.num_workers', '1',
        'system.compute_dtype', 'float32', 'weight.dir', str(tmp_path / 'w')])
    Trainer(cfg, device='cpu').run()
    wdir = os.path.join(cfg.weight.dir, cfg.experiment_name)
    report = run_diffeval(cfg, os.path.join(wdir, sorted(os.listdir(wdir))[-1]),
                          ref_path=ref, device='cpu')
    assert report['images'] >= 2
    assert report['match_rate'] > 0.97, report
    assert report['AP_delta'] < 0.01, report
    assert report['AP50_delta'] < 0.01, report
