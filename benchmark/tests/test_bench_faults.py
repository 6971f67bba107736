"""The check against the program broken underneath, and against the
control, at a size a CPU test holds: a run with a fault planted in the port
(``benchmark/faults.py``) skips the look for a card, drives the rest of a
run and must come out not correct; so must the control, the reference one
precision lower in the program's place. A sound run must come out correct.
On the card, ``benchmark/control.py`` reads the same at the cells' sizes."""

import pytest
import torch

from benchmark import compare, faults, harness
from benchmark.control import LOWER_PRECISION
from benchmark.trace import Tracer

SERVE = ['mnv2-serve-bf16-b80', 'rx600-serve-int8-b80', 'rx600-serve-bf16-b80']
TRAIN = ['mnv2-train-bf16-b32']
CPU = torch.device('cpu')
SEED = 2 ** 31 + 12345


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# a train step at a CPU test's size is badly conditioned: bf16's own rounding
# reads above the limits set at 512 and B=32, so the CPU steps in float32
TRAIN_SMALL = dict(batch=4, size=128, compute_dtype='float32')


def run(small, workload, **kw):
    spec, cell = small(workload, **(TRAIN_SMALL if workload in TRAIN else {}), **kw)
    return harness.run_cell(workload, SEED, 0.2, False, CPU, spec, cell)


@pytest.mark.parametrize('workload', SERVE + TRAIN)
def test_sound_run_is_correct(small, workload):
    out = run(small, workload)
    assert out['correct'], out['check']
    assert set(out['check']) == set(harness.load_cell(harness.load_spec(), workload)['limits'])


@pytest.mark.parametrize('workload,fault',
                         [(w, f) for w in SERVE for f in ('half_batch', 'altered')]
                         + [(w, f) for w in TRAIN for f in ('half_batch', 'unchanged', 'flipped')])
def test_planted_fault_is_not_correct(small, workload, fault):
    kind = 'train' if workload in TRAIN else 'serve'
    with faults.FAULTS[kind][fault]():
        out = run(small, workload)
    assert not out['correct'], out['check']


@pytest.mark.parametrize('workload,lowp',
                         [(w, LOWER_PRECISION['bf16' if 'bf16' in w else 'int8']) for w in SERVE]
                         + [(w, p) for w in TRAIN for p in ('fp8', 'fp8_bwd')])
def test_control_is_not_correct(small, workload, lowp):
    spec, cell = small(workload, **(TRAIN_SMALL if workload in TRAIN else
                                    dict(batch=4, size=128)))
    drv = harness.driver_of(cell, SEED, CPU, Tracer(False))
    drv.prepare_inputs()
    numbers = drv.control(lowp)
    correct, table = compare.judge(numbers, cell['limits'])
    assert not correct, table


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    """One short run of the first cell through the command, on the card."""
    import json
    import subprocess
    import sys
    spec = harness.load_spec()
    cmd = [sys.executable, str(harness.ROOT / 'benchmark' / 'run.py'), '--workload',
           spec['workloads'][0]['name'], '--seed', str(SEED), '--seconds', '2', '--trace', '0']
    done = subprocess.run(cmd, capture_output=True, text=True, timeout=600, check=True)
    out = json.loads(done.stdout.strip().splitlines()[-1])
    assert out['correct'] and out['device']['platform'] == 'gpu'
