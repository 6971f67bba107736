"""NAS search CLI (the port of ``pqdet_tpu/cli/search.py``).

    python -m pqdet_tpu_torch.cli.search --yaml yamls/nas_clutter.yaml \
        --rounds 50 --max-macs 5e9 [--max-latency-ms 20] [--log nas_search.json] \
        [--seed 0] [--exp-cap 40] [--device cuda|cpu] [key value ...]

Trailing ``key value`` pairs override the yaml; ``model.cfg_path`` is
supplied per candidate by the search. ``--max-latency-ms`` filters on the
candidate's B=1, 512x512 forward timed on ``--device``.

With ``system.data_devices`` (x ``train.spatial``) resolving to more than
one rank, or under torchrun, every candidate trains across the ranks as
``cli.train`` does (``--dist-backend``; ranks sharing a card take gloo):
the ranks sample the same candidates, rank 0 times them and evaluates,
and rank 0 alone prints and writes the log (``nas/search.py``).
"""

import argparse


def _search_rank(device, cfg, args):
    from pqdet_tpu_torch.nas.search import search
    return search(cfg, rounds=args.rounds, max_macs=args.max_macs,
                  log_path=args.log, max_latency_ms=args.max_latency_ms,
                  seed=args.seed, exp_cap=args.exp_cap, device=device)


def main(argv=None):
    from pqdet_tpu_torch.utils.debug import register_stack_dump
    register_stack_dump()
    parser = argparse.ArgumentParser(description='random NAS search')
    parser.add_argument('--yaml', default=None)
    parser.add_argument('--rounds', type=int, default=50)
    parser.add_argument('--max-macs', type=float, default=5e9)
    parser.add_argument('--max-latency-ms', type=float, default=None)
    parser.add_argument('--log', default='nas_search.json')
    parser.add_argument('--seed', type=int, default=None,
                        help='candidate-sampler seed (reproducible search)')
    parser.add_argument('--exp-cap', type=float, default=40.0,
                        help='decode exp clamp written into candidate '
                             'yolo sections (0 = bare exp, reference '
                             'semantics; see model/decode.py)')
    parser.add_argument('--device', default='cuda')
    from pqdet_tpu_torch.parallel.mesh import add_dist_args, run_ranks
    add_dist_args(parser)
    args, rest = parser.parse_known_args(argv)

    from pqdet_tpu_torch.config import load_config, platform_device
    cfg = load_config(args.yaml, rest)
    return run_ranks(_search_rank, cfg, platform_device(cfg, args.device), args.dist_backend,
                     (args,))


if __name__ == '__main__':
    main()
