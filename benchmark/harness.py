"""The benchmark's driver: one run of one cell, as ``run.py`` is called.

Everything a cell is made of is found by name from ``BENCHMARK.json``:

- the configuration's file (``configs/<name>.json``), which names its frozen
  ``.cfg`` beside it;
- the traffic mix, ``traffic/<traffic>.json``: parameters that ``serve.py``
  or ``train.py`` (its ``kind``) reads;
- the limits of the correctness check, ``limits/<workload>.json``;
- each per-layer metric's reader, ``metrics/<metric>.py``, a function
  ``read(rec)`` that returns a number, or None when it finds nothing to
  read. ``rec`` is the traced run's record (``trace.py``) with the cell
  added (``cell_record``): its ``layers`` as the reference's cfg reader
  gives them, its ``traffic`` (size, batch, precision ...), its
  ``config``, the ``n`` requests or steps and ``images`` of the window,
  the driver's ``counters``, and the ``untraced`` images and seconds of a
  window of the same length run just before with the profiler off. A
  reader works out what it needs from these (a kernel's bound from
  ``counts.py``), so a new metric is a new file and a new entry.

A cell, a mix, a configuration or a metric is added as new files and new
entries in ``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pqdet_tpu')
STREAMS = ('weights', 'pool', 'sample')


def load_spec(root: Path = ROOT) -> Dict:
    return json.loads((root / 'BENCHMARK.json').read_text())


def load_cell(spec: Dict, workload: str, root: Path = ROOT) -> Dict:
    """The workload's entry with its configuration, cfg text, traffic and
    limits read from their files."""
    w = next((w for w in spec['workloads'] if w['name'] == workload), None)
    if w is None:
        raise KeyError(f'no workload {workload!r} in BENCHMARK.json')
    c = next(c for c in spec['configs'] if c['name'] == w['config'])
    cfile = root / c['file']
    config = json.loads(cfile.read_text())
    return {'workload': w, 'config': config,
            'cfg_text': (cfile.parent / config['cfg']).read_text(),
            'traffic': json.loads((root / 'benchmark' / 'traffic' /
                                   f"{w['traffic']}.json").read_text()),
            'limits': json.loads((root / 'benchmark' / 'limits' /
                                  f'{workload}.json').read_text())}


def cell_metrics(spec: Dict, workload: str, kind: str):
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
    return [m for m in spec[kind] if workload in m.get('workloads', [workload])]


def load_reader(name: str, root: Path = ROOT) -> Callable:
    path = root / 'benchmark' / 'metrics' / f'{name}.py'
    mod_spec = importlib.util.spec_from_file_location(
        'benchmark_metric_' + name.replace('.', '_'), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def seed_streams(seed: int, device):
    """name -> a fresh generator of that stream of ``seed``: the same seed
    gives the same numbers, each stream its own. 'sample' is on the host."""
    import torch

    def gen(name: str):
        state = np.random.SeedSequence(entropy=int(seed), spawn_key=(STREAMS.index(name),))
        g = torch.Generator(device='cpu' if name == 'sample' else device)
        g.manual_seed(int(state.generate_state(1, np.uint64)[0]))
        return g
    return gen


def driver_of(cell: Dict, seed: int, device, tracer):
    from . import serve, train
    kind = cell['traffic']['kind']
    cls = {'serve': serve.Serve, 'train': train.Train}[kind]
    return cls(cell, seed_streams(seed, device), device, tracer)


def forbidden_modules():
    return sorted({m.split('.', 1)[0] for m in sys.modules} & set(FORBIDDEN))


def cell_record(rec: Dict, cell: Dict, e2e: Dict, counters: Dict,
                untraced: Optional[Dict] = None) -> Dict:
    """The traced record with what the readers need of the cell: its
    layers, traffic and configuration, the traced window's count of
    requests or steps and of images, the driver's counters, and
    ``untraced``: the images and seconds of the same window run just
    before with the profiler off (what the whole-step rates read)."""
    from .reference.cfg import layers
    return {**rec, 'layers': layers(cell['cfg_text']), 'traffic': cell['traffic'],
            'config': cell['config'], 'n': e2e.get('requests', e2e.get('steps')),
            'images': e2e['images'], 'counters': counters,
            'untraced': {k: untraced[k] for k in ('images', 'wall_s')} if untraced else None}


def per_layer_metrics(spec: Dict, workload: str, rec: Dict, root: Path = ROOT) -> Dict:
    """{name: {'value', 'unit'}} of the cell's per-layer metrics that
    their readers found something to read for."""
    out = {}
    for m in cell_metrics(spec, workload, 'per_layer'):
        v = load_reader(m['name'], root)(rec)
        if v is not None:
            out[m['name']] = {'value': v, 'unit': m['unit']}
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device,
             spec: Optional[Dict] = None, cell: Optional[Dict] = None,
             t_start: Optional[float] = None) -> Dict:
    """One run: set-up, the window, the traced record's metrics, the check.
    Returns the result object (``correct`` ... ``check``)."""
    import torch
    from . import compare, trace as T
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or load_spec()
    cell = cell or load_cell(spec, workload)
    on_card = device.type == 'cuda'
    tracer = T.Tracer(trace)
    drv = driver_of(cell, seed, device, tracer)
    drv.setup()
    setup_s = time.perf_counter() - t_start
    peak_setup = torch.cuda.max_memory_allocated(device) if on_card else 0
    untraced = None
    if trace:           # the rates of the whole-step metrics, free of the profiler's cost
        tracer.enabled = False
        untraced = drv.window(seconds)
        tracer.enabled = True
    with tracer:
        with tracer.span('window'):
            e2e = drv.window(seconds)
    peak = max(peak_setup, torch.cuda.max_memory_allocated(device)) if on_card else 0
    n = e2e.get('requests', e2e.get('steps'))
    result_metrics, extra = {}, {}
    if trace:
        rec = cell_record(tracer.record(), cell, e2e, drv.counters(), untraced)
        result_metrics = per_layer_metrics(spec, workload, rec)
        extra = {'busy_s': T.busy_s(rec), 'window_s': T.window_s(rec)}
        breakdown = T.breakdown(rec)
        del rec
    else:
        values = {**e2e, 'setup_s': setup_s}
        for m in cell_metrics(spec, workload, 'end_to_end'):
            if m['name'] in values:
                result_metrics[m['name']] = {'value': values[m['name']], 'unit': m['unit']}
    drv.free()
    if on_card:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = drv.check(seed_streams(seed, device)('sample'))
    print(f'check: {time.perf_counter() - t_check:.1f} s', file=sys.stderr)
    correct, table = compare.judge(numbers, cell['limits'])
    out = {'correct': bool(correct), 'attempted': n, 'failed': 0, 'metrics': result_metrics,
           'device': {'platform': 'gpu' if on_card else device.type,
                      'kind': torch.cuda.get_device_name(device) if on_card else 'cpu',
                      'count': cell['workload']['chips'], 'memory_peak_bytes': peak, **extra}}
    if trace:
        out['breakdown'] = breakdown
    out['check'] = table
    return out


def parse(argv):
    ap = argparse.ArgumentParser(description='Run one cell of BENCHMARK.json.')
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    spec = load_spec()
    cell = load_cell(spec, args.workload)
    import torch
    chips = cell['workload']['chips']
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'error: the cell needs {chips} CUDA device(s); found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    stdout = sys.stdout
    sys.stdout = sys.stderr         # the program's own prints stay off the result's stream
    try:
        out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                       torch.device('cuda', 0), spec, cell, t_start)
    finally:
        sys.stdout = stdout
    found = forbidden_modules()
    if found:
        print(f'error: the run loaded {", ".join(found)}', file=sys.stderr)
        return 3
    for k, v in out['check'].items():
        print(f"check {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


def set_cache_dirs(root: Path = ROOT):
    """Compile caches at fixed paths inside the checkout, set before torch
    or triton is imported."""
    cache = root / 'benchmark' / '.cache'
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
    os.environ['CUDA_CACHE_PATH'] = str(cache / 'cuda')
    os.environ.setdefault('USE_FLAX', '0')
