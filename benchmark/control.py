"""The readings that the check's limits are set from, at a cell's own size:

- the program's numbers on each of ``--seeds`` (a short window, then the
  check, as a run makes them): the lower readings;
- the control's on each of ``--control-seeds``: the plain reference computed
  one precision below the cell's (fp8 for bf16, int4 for int8) put in the
  program's place, against the float32 reference: the upper readings
  (``--controls`` names others, such as ``fp8_bwd`` of a training cell,
  fp8 in the backward too);
- with ``--faults``, the program's numbers with each fault of ``faults.py``
  planted, on the control seeds.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 \\
        --control-seeds 7,8,9 [--controls fp8,fp8_bwd] [--faults half_batch,altered] \\
        [--seconds 1]

Prints one JSON line per reading and needs a CUDA device; the benchmark's
own runs never run this.
"""

import contextlib
import json
import sys
from pathlib import Path

LOWER_PRECISION = {'bf16': 'fp8', 'int8': 'int4'}


def main(argv):
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--controls', default='')
    ap.add_argument('--faults', default='')
    ap.add_argument('--seconds', type=float, default=1.0)
    args = ap.parse_args(argv)
    from benchmark import faults, harness
    from benchmark.trace import Tracer
    import torch
    if not torch.cuda.is_available():
        print('error: no CUDA device', file=sys.stderr)
        return 2
    dev = torch.device('cuda', 0)
    spec = harness.load_spec()
    cell = harness.load_cell(spec, args.workload)
    kind = cell['traffic']['kind']
    controls = [c for c in args.controls.split(',') if c] or \
        [LOWER_PRECISION[cell['traffic']['precision']]]
    seeds = lambda s: [int(x) for x in s.split(',') if x]  # noqa: E731

    def emit(what, seed, numbers, counters=None):
        print(json.dumps({'workload': args.workload, 'reading': what, 'seed': seed,
                          'numbers': numbers, 'counters': counters}), flush=True)

    def program(seed, fault=None):
        drv = harness.driver_of(cell, seed, dev, Tracer(False))
        with faults.FAULTS[kind][fault]() if fault else contextlib.nullcontext():
            drv.setup()
            drv.window(args.seconds)
            counters = drv.counters()
            drv.free()
        torch.cuda.empty_cache()
        numbers = drv.check(harness.seed_streams(seed, dev)('sample'))
        del drv
        torch.cuda.empty_cache()
        return numbers, counters

    for seed in seeds(args.seeds):
        emit('program', seed, *program(seed))
    for seed in seeds(args.control_seeds):
        drv = harness.driver_of(cell, seed, dev, Tracer(False))
        drv.prepare_inputs()
        for lowp in controls:
            emit(f'control:{lowp}', seed, drv.control(lowp))
        del drv
        torch.cuda.empty_cache()
        for fault in [f for f in args.faults.split(',') if f]:
            emit(f'fault:{fault}', seed, *program(seed, fault))
    return 0


if __name__ == '__main__':
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from benchmark import harness as _h
    _h.set_cache_dirs()
    sys.exit(main(sys.argv[1:]))
