"""``system.platform`` and the stack dump of the port's CLIs, against the
JAX package's: the key loads with JAX's default ``''``; ``cpu`` sends the
CLIs and the Trainer to the CPU whatever ``--device`` says, ``''`` keeps
``--device``, any other value raises naming the key; ``train``, ``prune``
and ``bench`` register ``faulthandler`` on SIGUSR1 first, as JAX's
(``pqdet_tpu/utils/debug.py``), so ``kill -USR1 <pid>`` prints every
thread's stack."""

import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from pqdet_tpu.config import load_config as jax_load_config
from pqdet_tpu_torch.config import load_config, platform_device
from pqdet_tpu_torch.train.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent


def test_platform_loads_as_jax():
    """The default and ``cpu``, from an override list and from a yaml, load
    as in JAX."""
    assert load_config().system.platform == jax_load_config().system.platform == ''
    opts = ['system.platform', 'cpu']
    assert load_config(None, opts).system.platform == jax_load_config(None, opts).system.platform
    assert load_config(str(REPO / 'yamls' / 'shapes.yaml'), opts).system.platform == 'cpu'


@pytest.mark.parametrize('platform,device,want', [('', 'cuda', 'cuda'), ('', 'cpu', 'cpu'),
                                                  ('cpu', 'cuda', 'cpu'), ('cpu', 'cpu', 'cpu')])
def test_platform_device(platform, device, want):
    opts = ['system.platform', platform] if platform else []
    assert platform_device(load_config(None, opts), device) == want


@pytest.mark.parametrize('platform', ['tpu', 'gpu', 'cuda'])
def test_other_platforms_raise_naming_the_key(platform):
    with pytest.raises(ValueError, match='system.platform'):
        load_config(None, ['system.platform', platform])


def test_trainer_follows_platform():
    """``system.platform cpu`` puts the Trainer on the CPU though it is asked
    for the card (which this host lacks: without the key it raises)."""
    cfg = load_config(str(REPO / 'yamls' / 'shapes.yaml'), ['system.platform', 'cpu'])
    assert Trainer(cfg, device='cuda').device == torch.device('cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='torch.cuda.is_available'):
            Trainer(load_config(str(REPO / 'yamls' / 'shapes.yaml')), device='cuda')


def test_bench_cli_follows_platform(capsys):
    """``bench time`` with ``--device cuda`` and ``system.platform cpu``
    times the forward on the CPU (the host clock)."""
    from pqdet_tpu_torch.cli import bench
    t = bench.main(['time', '--device', 'cuda', '--size', '32', 'system.platform', 'cpu'])
    assert t['p50'] > 0
    assert '[host clock]' in capsys.readouterr().out


# each CLI's main with its first step after register_stack_dump replaced by
# a sleep the test interrupts with SIGUSR1
SLEEPERS = {
    'train': ('pqdet_tpu_torch.cli.train', 'load_config'),
    'prune': ('pqdet_tpu_torch.config', 'load_config'),
    'bench': ('pqdet_tpu_torch.config', 'load_config'),
}


@pytest.mark.parametrize('cli', sorted(SLEEPERS))
def test_cli_dumps_stacks_on_sigusr1(cli, tmp_path):
    """SIGUSR1 to a process running the CLI's main prints the main thread's
    stack to stderr (the process keeps running until it is killed)."""
    mod, attr = SLEEPERS[cli]
    code = f'''
import importlib, sys, time
target = importlib.import_module({mod!r})

def wedged_here(*a, **k):
    print('ready', flush=True)
    time.sleep(120)

setattr(target, {attr!r}, wedged_here)
main = importlib.import_module('pqdet_tpu_torch.cli.{cli}').main
main({['time'] if cli == 'bench' else []!r})
'''
    err = tmp_path / 'stderr.txt'
    with open(err, 'w') as fe:
        proc = subprocess.Popen([sys.executable, '-c', code], cwd=REPO, stdout=subprocess.PIPE,
                                stderr=fe, text=True)
        try:
            assert proc.stdout.readline().strip() == 'ready'
            os.kill(proc.pid, signal.SIGUSR1)
            deadline = time.time() + 30
            while 'wedged_here' not in err.read_text() and time.time() < deadline:
                time.sleep(0.1)
            assert proc.poll() is None
        finally:
            proc.kill()
            proc.wait()
    text = err.read_text()
    assert 'most recent call first' in text and 'wedged_here' in text, text
    assert f'pqdet_tpu_torch/cli/{cli}.py' in text, text
