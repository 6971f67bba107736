"""Hyper-parameter evolution CLI (the port of ``pqdet_tpu/cli/evolute.py``).

    python -m pqdet_tpu_torch.cli.evolute --yaml yamls/evolute_clutter.yaml \
        --rounds 200 [--log evolution.json] [--seed 0] [--device cuda|cpu] \
        [key value ...]

Trailing ``key value`` pairs override the yaml. A segfault or abort prints
every thread's stack (``faulthandler``), and ``kill -USR1 <pid>`` prints
them on demand.

With ``system.data_devices`` (x ``train.spatial``) resolving to more than
one rank, or under torchrun, every round trains across the ranks as
``cli.train`` does (``--dist-backend``; ranks sharing a card take gloo):
the ranks draw the same hypers, rank 0 evaluates, and rank 0 alone prints
and writes the log (``nas/evolute.py``).
"""

import argparse


def _evolute_rank(device, cfg, args):
    from pqdet_tpu_torch.nas.evolute import Evoluter
    return Evoluter(cfg, rounds=args.rounds, log_path=args.log, seed=args.seed,
                    device=device).run()


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
    from pqdet_tpu_torch.parallel.mesh import add_dist_args, run_ranks
    add_dist_args(parser)
    args, rest = parser.parse_known_args(argv)

    from pqdet_tpu_torch.config import load_config, platform_device
    cfg = load_config(args.yaml, rest)
    return run_ranks(_evolute_rank, cfg, platform_device(cfg, args.device),
                     args.dist_backend, (args,))


if __name__ == '__main__':
    main()
