"""The port's anchor k-means (``pqdet_tpu_torch/cli/anchors.py``) against
the JAX package's: ``iou_wh`` and ``kmeans_anchors`` equal on seeded box
sizes, and the CLI on a synth_shapes VOC set prints JAX's anchors."""

import sys

import numpy as np
import pytest

from pqdet_tpu.cli import anchors as jax_anchors
from pqdet_tpu_torch.cli import anchors
from pqdet_tpu_torch.data.scripts.synth_shapes import generate

CLASSES = ['dataset.classes', '[square, circle, triangle]']


def _whs(seed):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.rand(80, 2) * 5 + c for c in ([10, 10], [60, 40], [200, 180])])


@pytest.mark.parametrize('seed', [0, 1])
def test_iou_wh_equals_jax(seed):
    whs = _whs(seed)
    centers = _whs(seed + 10)[::37]
    np.testing.assert_array_equal(anchors.iou_wh(whs, centers),
                                  jax_anchors.iou_wh(whs, centers))


@pytest.mark.parametrize('k,seed', [(3, 0), (9, 0), (5, 4)])
def test_kmeans_anchors_equals_jax(k, seed):
    whs = _whs(seed)
    got = anchors.kmeans_anchors(whs, k=k, seed=seed)
    np.testing.assert_array_equal(got, jax_anchors.kmeans_anchors(whs, k=k, seed=seed))
    assert got.shape == (k, 2) and (np.diff(got[:, 0] * got[:, 1]) >= 0).all()


def test_cli_prints_jax_anchors(tmp_path, capsys, monkeypatch):
    generate(str(tmp_path), n=24, size=96, seed=2, holdout=0.25)
    argv = ['--txt', str(tmp_path / 'train.txt'), '-k', '4', *CLASSES]
    got = anchors.main(argv)
    port_out = capsys.readouterr().out
    monkeypatch.setattr(sys, 'argv', ['anchors', *argv])
    jax_anchors.main()
    assert port_out == capsys.readouterr().out
    assert got.shape == (4, 2)
