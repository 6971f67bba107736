"""End-to-end LEARNING with the port (the port of tests/test_learning.py): the
whole pipeline (data, device labels, loss, train step, eval, AP) must fit
an easy synthetic task, not just run. Bright squares on dark backgrounds,
one class: the JAX tests' net, corpus, options, epochs and AP floors.

The tasks themselves live in ``chip_smoke.py`` (``learn_squares``,
``sparse_prune_finetune``), whose phase 17 (a) runs them on the card; here
they run on the CPU (slow), and a fast test holds their net, corpus and
options to tests/test_learning.py's."""

import os

import pytest

import chip_smoke
from pqdet_tpu.config import load_config as jax_load_config
from pqdet_tpu_torch.config import load_config
from test_learning import CFG, _make_square_dataset


def test_squares_task_is_the_jax_tests(tmp_path):
    """chip_smoke's copy of the learning task: tests/test_learning.py's cfg
    text, the same corpus byte for byte, and its options loading to the
    values JAX's config loads."""
    assert chip_smoke.SQUARES_CFG == CFG
    assert (chip_smoke.SQUARES_AP50, chip_smoke.PRUNED_SQUARES_AP50) == (0.5, 0.4)
    ours = chip_smoke.write_squares(str(tmp_path / 'port'))
    theirs = _make_square_dataset(str(tmp_path / 'jax'))
    for a, b in zip(open(ours).read().split('\n'), open(theirs).read().split('\n'),
                    strict=True):
        assert os.path.relpath(a, tmp_path / 'port') == os.path.relpath(b, tmp_path / 'jax')
        assert open(a, 'rb').read() == open(b, 'rb').read()
        xa, xb = (p.replace('JPEGImages', 'Annotations').replace('.jpg', '.xml') for p in (a, b))
        assert open(xa).read() == open(xb).read()
    opts = chip_smoke.squares_opts(ours, 'sq.cfg', str(tmp_path / 'w')) + [
        'train.max_epochs', '14', 'eval.after', '13']
    cfg, jcfg = load_config(opts=opts), jax_load_config(opts=opts)
    for key in opts[::2]:
        group, leaf = key.split('.')
        assert getattr(getattr(cfg, group), leaf) == getattr(getattr(jcfg, group), leaf), key


@pytest.mark.slow
def test_detector_learns_synthetic_squares(tmp_path):
    ap50, _ = chip_smoke.learn_squares(str(tmp_path / 'sq'), device='cpu')
    assert ap50 > 0.5, f'detector failed to learn: AP50={ap50:.3f}'


@pytest.mark.slow
def test_sparse_prune_finetune_cycle(tmp_path):
    """The compression pipeline on the squares: sparse-train -> prune 30 % ->
    fine-tune -> AP survives."""
    ap50, n0, n1, _ = chip_smoke.sparse_prune_finetune(str(tmp_path / 'sq'), device='cpu')
    assert n1 < n0
    assert ap50 > 0.4, f'pruned+finetuned detector too weak: AP50={ap50:.3f}'
