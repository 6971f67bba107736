"""The port's AP evaluator against the JAX package's on the CPU: the same
detections and labels give the same AP to 1e-12 through the port's native
matcher and its Python matcher; ``evaluate`` over EvalData batches runs its
predict under ``torch.inference_mode()``; the matcher builds race-free in
concurrent processes and a failed build raises."""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from pqdet_tpu.config import load_config as jax_load_config
from pqdet_tpu.data.eval_data import EvalData as JaxEvalData
from pqdet_tpu.evaluation.evaluator import Evaluator as JaxEvaluator
from pqdet_tpu.evaluation.evaluator import format_ap_table as jax_format_ap_table
from pqdet_tpu_torch.config import load_config
from pqdet_tpu_torch.data.eval_data import EvalData
from pqdet_tpu_torch.evaluation.evaluator import Evaluator, format_ap_table
from pqdet_tpu_torch.native import matcher
from test_data import _write_voc_fixture

REPO = Path(__file__).resolve().parent.parent


class _Cfg:
    class dataset:
        classes = ['a', 'b', 'c']

    class system:
        num_workers = 1
        prefetch = 2


def _feed(ev, seed):
    """The randomized scenario of tests/test_native.py: GT with difficult
    flags, detections near GT and random ones, tied scores."""
    rng = np.random.RandomState(seed)
    for f in range(rng.randint(2, 6)):
        n_gt = rng.randint(1, 8)
        lt = rng.rand(n_gt, 2) * 200
        wh = rng.rand(n_gt, 2) * 60 + 10
        cls = rng.randint(0, 3, size=(n_gt, 1))
        boxes = np.concatenate([lt, lt + wh, cls], -1).astype(np.float32)
        diffs = (rng.rand(n_gt) < 0.3).astype(np.float64)
        ev.add_labels(f'f{f}', boxes, diffs)
        n_det = rng.randint(1, 12)
        det_lt = rng.rand(n_det, 2) * 220
        det_wh = rng.rand(n_det, 2) * 60 + 10
        jitter = rng.randn(n_det, 4) * 4
        near = np.concatenate([lt, lt + wh], -1)[rng.randint(0, n_gt, n_det)] + jitter
        use_near = rng.rand(n_det) < 0.6
        det_boxes = np.where(use_near[:, None], near,
                             np.concatenate([det_lt, det_lt + det_wh], -1))
        scores = np.round(rng.rand(n_det), 2)
        det_cls = rng.randint(0, 3, n_det)
        ev.add_detections(f'f{f}', np.concatenate(
            [det_boxes, scores[:, None], det_cls[:, None]], -1).astype(np.float32))
    return ev


def _assert_ap_equal(got, want):
    for key in ('raw', 'APs', 'mAPs'):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key), rtol=0, atol=1e-12)
    assert abs(got.AP - want.AP) <= 1e-12


@pytest.mark.parametrize('seed', range(10))
@pytest.mark.parametrize('native', [True, False])
def test_ap_matches_jax(seed, native):
    want = _feed(JaxEvaluator(None, None, _Cfg), seed).compute_ap()
    got = _feed(Evaluator(None, None, _Cfg, native=native), seed).compute_ap()
    _assert_ap_equal(got, want)
    assert format_ap_table(got) == jax_format_ap_table(want)
    assert format_ap_table(got, verbose=False) == jax_format_ap_table(want, verbose=False)


def test_evaluate_matches_jax(tmp_path):
    """evaluate() over the VOC fixture's eval batches (a ragged last batch)
    with detections made from each file's GT: the same AP as JAX's, and the
    port's predict runs under inference mode."""
    txt = _write_voc_fixture(str(tmp_path), n=6, seed=3)
    opts = ['dataset.eval_txt_file', txt, 'dataset.classes', '[cat, dog, bird]',
            'eval.batch_size', '4', 'eval.input_size', '96', 'system.num_workers', '2']
    modes = []

    def predict(batch):
        modes.append(torch.is_inference_mode_enabled())
        out = []
        for i in range(batch['count']):
            boxes = batch['bboxes'][i]
            rng = np.random.RandomState(len(boxes) * 7 + i)
            jit = boxes[:, :4] + rng.randn(len(boxes), 4) * 5
            scores = np.round(rng.rand(len(boxes), 1), 1)
            out.append(np.concatenate([jit, scores, boxes[:, 4:5]], 1).astype(np.float32))
        return out

    want = JaxEvaluator(predict, JaxEvalData(jax_load_config(opts=opts)),
                        jax_load_config(opts=opts)).evaluate()
    modes.clear()
    cfg = load_config(opts=opts)
    got = Evaluator(predict, EvalData(cfg), cfg).evaluate()
    _assert_ap_equal(got, want)
    assert modes == [True, True] and got.AP > 0


def test_native_build_per_process(tmp_path):
    """Six processes build the matcher into one empty directory at once:
    each loads a working library, one .so is left and no temporary file."""
    code = textwrap.dedent(f"""
        import numpy as np
        from pathlib import Path
        from pqdet_tpu_torch.native import matcher
        matcher.BUILD_DIR = Path({str(tmp_path)!r})
        tp, fp = matcher.match_class(
            np.array([[0, 0, 10, 10]], np.float32), np.zeros(1, np.int32),
            np.array([[0, 0, 10, 10]], np.float32), np.zeros(1, bool),
            np.array([0, 1], np.int32), np.array([0.5]))
        assert tp.tolist() == [[1.0]] and fp.tolist() == [[0.0]]
    """)
    procs = [subprocess.Popen([sys.executable, '-c', code], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(6)]
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out
    left = sorted(f.name for f in tmp_path.iterdir())
    assert len(left) == 1 and left[0].endswith('.so'), left


def test_native_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / 'ap_matcher.cpp'
    bad.write_text('this is not C++\n')
    monkeypatch.setattr(matcher, 'SOURCE', bad)
    monkeypatch.setattr(matcher, 'BUILD_DIR', tmp_path / 'build')
    with pytest.raises(RuntimeError, match='g\\+\\+ could not build'):
        matcher.build()
