"""Tests of the benchmark. Those marked ``card`` need a CUDA device and skip
without one; the decision is made in the ``card`` fixture, at run time."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line('markers', 'card: needs a CUDA device (skips without one)')


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda', 0)


@pytest.fixture
def small():
    """A cell of BENCHMARK.json cut to a CPU test's size: (spec, cell)."""
    from benchmark import harness

    def make(workload, **kw):
        spec = harness.load_spec()
        cell = harness.load_cell(spec, workload)
        cell['traffic'].update({**dict(batch=2, size=64, pool=4, check_requests=2,
                                       calib_batch=2, warmup=1), **kw})
        return spec, cell
    return make
