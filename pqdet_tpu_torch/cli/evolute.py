"""Hyper-parameter evolution CLI (the port of ``pqdet_tpu/cli/evolute.py``).

    python -m pqdet_tpu_torch.cli.evolute --yaml yamls/evolute_clutter.yaml \
        --rounds 200 [--log evolution.json] [--seed 0] [--device cuda|cpu] \
        [key value ...]

Trailing ``key value`` pairs override the yaml. A segfault or abort prints
every thread's stack (``faulthandler``), and ``kill -USR1 <pid>`` prints
them on demand. Evolution runs one rank: ``system.data_devices`` above 1
raises (ROADMAP.md queue 1, item 7).
"""

import argparse


def main(argv=None):
    from pqdet_tpu_torch.utils.debug import enable_fault_dump, register_stack_dump
    enable_fault_dump()
    register_stack_dump()
    parser = argparse.ArgumentParser(description='hyper evolution')
    parser.add_argument('--yaml', default=None)
    parser.add_argument('--rounds', type=int, default=200)
    parser.add_argument('--log', default='evolution.json')
    parser.add_argument('--seed', type=int, default=None)
    parser.add_argument('--device', default='cuda')
    args, rest = parser.parse_known_args(argv)

    from pqdet_tpu_torch.config import load_config, one_rank, platform_device
    from pqdet_tpu_torch.nas.evolute import Evoluter
    cfg = load_config(args.yaml, rest)
    one_rank(cfg, 'cli.evolute')
    return Evoluter(cfg, rounds=args.rounds, log_path=args.log, seed=args.seed,
                    device=platform_device(cfg, args.device)).run()


if __name__ == '__main__':
    main()
