"""NAS search and hyper-parameter evolution across ranks on the CPU: two gloo
ranks run ``search`` (2 candidates) and ``Evoluter.run`` (1 round) on the
4-image VOC fixture at 64 px, each candidate and round training
data-parallel, against the same search and evolution in one process with
the same seed. What each candidate and round trained is held with
``chip_smoke.nas_ranks_agree``: rank 0's step losses and params (recorded
by ``chip_smoke.trained_probe``) against one process's, within 2x the
one-process run's own drift on its batches' rows reversed; the AP of this
short training sits near 0, where an AP check cannot fail
(``tests/test_torch_corpus_ranks.py`` shows that the gate fails on planted
faults). One spawn (``ranks``, module scope) also checks the decisions the
ranks take together: a seed of None, the latency filter and a failure on
one rank. The rank side of this module imports no JAX.
"""

import json
import os

import pytest
import torch

import chip_smoke

from pqdet_tpu_torch.config import load_config
from pqdet_tpu_torch.nas import search as search_mod
from pqdet_tpu_torch.nas.evolute import Evoluter
from pqdet_tpu_torch.parallel import mesh

W = 2


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
            'model.max_gt_boxes', '8', 'train.batch_size', '2', 'train.input_sizes', '[64]',
            'train.warmup_epochs', '0.5', 'eval.after', '0', 'eval.batch_size', '2',
            'eval.input_size', '64', 'eval.max_detections', '16',
            'weight.dir', f'{root}/w', 'system.num_workers', '1',
            'system.compute_dtype', 'float32', 'system.data_devices', str(W)]


def _search_and_evolve(root, tag, device='cpu', reverse=False):
    """2 searched candidates and 1 evolution round of seed 0, logged under
    ``root`` with ``tag`` (``reverse``: each step's rows reversed); returns
    the records and what each candidate and round trained
    (``chip_smoke.trained_probe``)."""
    trained = []
    restore = chip_smoke.trained_probe(trained)
    flip = chip_smoke.reversed_rows() if reverse else (lambda: None)
    try:
        cfg = load_config(opts=_opts(root))
        recs = search_mod.search(cfg, rounds=2, log_path=f'{root}/nas_{tag}.json', seed=0,
                                 device=device)
        evo_cfg = load_config(opts=_opts(root) + ['model.cfg_path', f'{root}/tiny.cfg'])
        evo = Evoluter(evo_cfg, rounds=1, log_path=f'{root}/evo_{tag}.json', seed=0,
                       device=device).run()
    finally:
        flip()
        restore()
    return recs, evo, trained


def _rank_work(dev, root):
    r = mesh.rank()
    res = {'seed': search_mod.shared_seed(None),
           'failure': search_mod.shared_failure('boom on rank 1' if r == 1 else None),
           'no_failure': search_mod.shared_failure(None)}
    measure = search_mod.measure_latency
    search_mod.measure_latency = lambda *a, **k: 1.0 + r
    try:
        res['latency'] = next(search_mod.generate_candidates(
            1, max_latency_ms=100.0, num_classes=3, seed=0, device=dev))[1]['latency_ms']
    finally:
        search_mod.measure_latency = measure
    res['search'], res['evo'], res['trained'] = _search_and_evolve(root, 'ranks', dev)
    torch.save(res, os.path.join(root, f'rank{r}.pt'))


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    from test_data import _write_voc_fixture
    from test_e2e import TINY_DET
    root = str(tmp_path_factory.mktemp('nas_ranks'))
    txt = _write_voc_fixture(root, n=4)
    os.replace(txt, os.path.join(root, 'list.txt'))
    with open(os.path.join(root, 'tiny.cfg'), 'w') as fw:
        fw.write(TINY_DET)
    mesh.launch(_rank_work, W, 'cpu', 'gloo', (root,), timeout_s=300)
    return [torch.load(os.path.join(root, f'rank{r}.pt'), weights_only=False)
            for r in range(W)], root


def _read(path):
    with open(path) as fr:
        return json.load(fr)


def test_ranks_decide_together(ranks):
    """A seed of None is rank 0's draw on both ranks; the latency filter
    sees rank 0's measurement; a failure on one rank is the failure on
    both, with its error; no failure is None on both."""
    (r0, r1), _ = ranks
    assert isinstance(r0['seed'], int) and r0['seed'] == r1['seed']
    assert r0['latency'] == r1['latency'] == 1.0
    assert r0['failure'] == r1['failure'] == 'boom on rank 1'
    assert r0['no_failure'] is r1['no_failure'] is None


def test_search_and_evolution_across_ranks_match_one_process(ranks, capsys):
    """The two ranks' search log and evolution log are written once, by
    rank 0, and hold what rank 0 returned (every rank returns the same
    records, apart from the evolution's per-process telemetry); their
    candidates (cfg text, MACs, params, head) and statuses are the
    one-process search's of seed 0, the hypers of the round the one-process
    round's, the APs and fitness within 0.05 of one process's; and what
    every candidate and the round trained passes ``nas_ranks_agree`` against
    one process (each rank trained the same params)."""
    (r0, r1), root = ranks

    def hypers(recs):       # the telemetry is each process's own
        return [(r['hyper'], r['fitness']) for r in recs]
    assert r0['search'] == r1['search'] and hypers(r0['evo']) == hypers(r1['evo'])
    log, evo_log = _read(f'{root}/nas_ranks.json'), _read(f'{root}/evo_ranks.json')
    assert log['data'] == r0['search'] and evo_log['data'] == r0['evo']
    assert evo_log['exit'] == {'status': 'completed', 'completed_rounds': 1,
                               'target_rounds': 1}
    one, one_evo, one_trained = _search_and_evolve(root, 'one')
    *_, rev_trained = _search_and_evolve(root, 'reversed', reverse=True)
    assert len(r0['trained']) == len(r1['trained']) == 3
    assert all(torch.equal(a['params'], b['params'])
               for a, b in zip(r0['trained'], r1['trained']))
    ok, rows, pooled = chip_smoke.nas_ranks_agree(r0['trained'], one_trained, rev_trained)
    print(f'what the ranks trained against one process (steps, first-loss rel, params L2, '
          f'one process reversed L2): {rows}; pooled {pooled}')
    assert ok, (rows, pooled)
    assert len(one) == len(r0['search']) == 2 and len(one_evo) == len(r0['evo']) == 1
    for a, b in zip(r0['search'], one):
        for k in ('cfg', 'macs', 'params', 'head', 'status'):
            assert a[k] == b[k], k
        assert a['status'] == 'completed'
        assert abs(a['ap'] - b['ap']) <= 0.05, (a['ap'], b['ap'])
    assert r0['evo'][0]['hyper'] == one_evo[0]['hyper']
    assert abs(r0['evo'][0]['fitness'] - one_evo[0]['fitness']) <= 0.05
    print(f"APs across ranks {[a['ap'] for a in r0['search']]}, one process "
          f"{[b['ap'] for b in one]}; fitness {r0['evo'][0]['fitness']} and "
          f"{one_evo[0]['fitness']}")
