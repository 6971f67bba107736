"""The port's NAS log analysis (``pqdet_tpu_torch/nas/analysis.py``) and
drawing helpers (``utils/draw.py``) against the JAX package's on the CPU:
tests/test_nas_export.py::test_nas_edf_analysis's planted records (a wider
first head branch is better), with diverged candidates beside them; the
EDF, AUC, filters, ``compare_edf`` and ``search_width_windows`` to 1e-12;
the CLI and every drawing function writing its file, as
tests/test_nas_export.py::test_draw_helpers checks."""

import json
import os

import numpy as np
import pytest
import torch

from pqdet_tpu.nas import analysis as jax_analysis
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.nas import analysis
from pqdet_tpu_torch.train.checkpoint import save_checkpoint
from pqdet_tpu_torch.utils.draw import draw_bn_scatter, draw_evolution, draw_prune_bars
from test_prune import _mobile_style_cfg

TOL = 1e-12


def _planted():
    rng = np.random.RandomState(0)
    records = []
    for k in range(60):
        w0 = int(rng.choice([64, 128, 256, 512]))
        ap = float(np.clip(0.3 + 0.3 * (w0 >= 256) + rng.randn() * 0.05, 0, 1))
        records.append({
            'cfg': '', 'ap': ap, 'macs': float(2e9 + k), 'params': 1e6,
            'latency_ms': 5.0 + (k % 7),
            'head': {'widths': [w0, 256, 128], 'depth': 1 + k % 6,
                     'group_ws': [8, 8, 8]}})
    return records


@pytest.fixture
def log(tmp_path):
    """The planted records and two diverged candidates, as a search log."""
    data = _planted()
    data.insert(7, {'cfg': '', 'macs': 3e9, 'params': 1e6, 'status': 'diverged', 'ap': None,
                    'step_of_death': 88, 'error': 'NaN in loss near step 88',
                    'head': {'widths': [96, 120, 32], 'depth': 2, 'group_ws': [1, 1, 1]}})
    data.append(dict(data[7], step_of_death=None, error='other'))
    path = tmp_path / 'nas.json'
    path.write_text(json.dumps({'meta': {}, 'data': data}))
    return str(path)


def test_load_records_as_jax(log):
    recs = analysis.load_records(log)
    assert recs == jax_analysis.load_records(log) and len(recs) == 60
    assert analysis.load_all_records(log) == jax_analysis.load_all_records(log)
    assert len(analysis.load_all_records(log)) == 62
    assert analysis.best_record(recs) == jax_analysis.best_record(recs)


@pytest.mark.parametrize('shift', [0.0, 0.2])
def test_edf_and_auc_equal_jax(log, shift):
    recs = [dict(r, ap=min(r['ap'] + shift, 1.0)) for r in analysis.load_records(log)]
    errors, probs = analysis.compute_edf(recs)
    jerrors, jprobs = jax_analysis.compute_edf(recs)
    np.testing.assert_allclose(errors, jerrors, rtol=0, atol=TOL)
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=TOL)
    assert (np.diff(errors) >= 0).all() and probs[-1] == 1.0
    auc = analysis.compute_auc(errors, probs)
    assert abs(auc - jax_analysis.compute_auc(jerrors, jprobs)) <= TOL


FILTERS = {
    'ap': ('ap_filter', (0.4, 0.9)),
    'macs': ('macs_filter', (2e9 + 10, 2e9 + 40)),
    'latency': ('latency_filter', (4.9, 9.0)),
    'depth': ('depth_filter', (1, 3)),
    'width': ('width_filter', ([256, 0, 0], [1024, 1024, 1024])),
    'width_scalar': ('width_filter', (100, 600)),
}


@pytest.mark.parametrize('name', sorted(FILTERS))
def test_filters_and_compare_edf_equal_jax(log, name):
    fn, args = FILTERS[name]
    recs = analysis.load_records(log)
    flt, jflt = getattr(analysis, fn)(*args), getattr(jax_analysis, fn)(*args)
    assert [flt(r) for r in recs] == [jflt(r) for r in recs]
    inv = analysis.invert(flt)
    assert [inv(r) for r in recs] == [not jflt(r) for r in recs]
    rep, jrep = analysis.compare_edf(recs, flt), jax_analysis.compare_edf(recs, jflt)
    assert rep.keys() == jrep.keys()
    for k in rep:
        assert rep[k] == jrep[k] or abs(rep[k] - jrep[k]) <= TOL, k
    if name == 'width':
        assert rep['delta'] > 0.05       # the planted wide-first-branch region


@pytest.mark.parametrize('step', [24, 64])
def test_search_width_windows_equal_jax(log, step):
    recs = analysis.load_records(log)
    got = analysis.search_width_windows(recs, step=step)
    want = jax_analysis.search_width_windows(recs, step=step)
    assert [g[1:] for g in got] == [w[1:] for w in want] and got
    np.testing.assert_allclose([g[0] for g in got], [w[0] for w in want], rtol=0, atol=TOL)
    if step == 64:
        assert got[0][1] == 0 and got[0][2] >= 192


def test_draw_edf_and_cli_write_their_files(log, tmp_path, capsys):
    recs = analysis.load_records(log)
    out = analysis.draw_edf([recs, recs[:30]], ['all', 'half'], str(tmp_path / 'edf.png'))
    assert os.path.getsize(out) > 0
    analysis.main([log, '--out', str(tmp_path / 'res'), '--width-step', '64'])
    text = capsys.readouterr().out
    assert '60 records; best: AP=' in text and 'best width window: branch 0' in text
    assert sorted(os.listdir(tmp_path / 'res')) == ['EDF.png', 'compare_EDF.png']


def test_draw_helpers(tmp_path):
    """The BN-gamma scatter and prune bars from port checkpoints (two
    different weights), the evolution scatter from an evolution log."""
    net = DetectionNetwork.from_cfg(_mobile_style_cfg())
    cks = []
    for seed in (0, 1):
        params, state = net.init(torch.Generator().manual_seed(seed), device='cpu')
        cks.append(str(tmp_path / f'{seed}.ckpt'))
        save_checkpoint(cks[-1], net.graph, params, state, step=0, cfg_text='')
    out = draw_bn_scatter(cks, labels=['a', 'b'], save_path=str(tmp_path / 'bn.png'))
    assert os.path.getsize(out) > 0
    out = draw_prune_bars(cks[0], cks[1], save_path=str(tmp_path / 'bars.png'))
    assert os.path.getsize(out) > 0
    evo = str(tmp_path / 'evo.json')
    with open(evo, 'w') as fw:
        json.dump({'data': [{'hyper': {'a': 0.5, 'b': 1.0}, 'fitness': 0.3},
                            {'hyper': {'a': 0.7, 'b': 0.5}, 'fitness': 0.4}]}, fw)
    out = draw_evolution(evo, save_path=str(tmp_path / 'evo.png'))
    assert os.path.getsize(out) > 0
    with open(evo, 'w') as fw:
        json.dump({'data': []}, fw)
    with pytest.raises(ValueError):
        draw_evolution(evo, save_path=str(tmp_path / 'none.png'))
