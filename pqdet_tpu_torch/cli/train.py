"""Training CLI (the port of ``pqdet_tpu/cli/train.py``).

    python -m pqdet_tpu_torch.cli.train --yaml yamls/shapes.yaml \
        [--device cuda|cpu] [--dist-backend nccl|gloo] [key value ...]

Trailing ``key value`` pairs override the yaml (dotted keys, e.g.
``train.max_epochs 3``); ``system.platform cpu`` runs on the CPU whatever
``--device`` says. ``kill -USR1 <pid>`` prints every thread's stack.

Data parallelism (``parallel/mesh.py``): when ``system.data_devices``
resolves to W > 1 ranks (on the card: GPUs, 0 = every visible one; on the
CPU: gloo processes), the CLI spawns one rank per GPU (per process on the
CPU), each training its slice of every global batch. Under torchrun
(``RANK`` and ``WORLD_SIZE`` set) it joins torchrun's group instead, one
rank per process, which is how several hosts train together.
``--dist-backend`` is nccl on the card and gloo on the CPU by default;
ranks that share a card need gloo. Only rank 0 prints the config and the
metrics, evaluates and writes checkpoints. ``train.spatial N`` cuts each
image's rows into N bands across the ranks as well (``n_data x N`` ranks,
``system.data_devices`` the total budget; ``train/trainer.py``).
"""

import argparse

from pqdet_tpu_torch.config import load_config, platform_device
from pqdet_tpu_torch.utils.debug import register_stack_dump


def _train_rank(device, cfg):
    from pqdet_tpu_torch.parallel.mesh import is_main
    if is_main():
        print(cfg)
    # imported here: with system.loader process the spawned workers import
    # this module as their main one, and need neither torch nor the trainer
    from pqdet_tpu_torch.train import trainer
    trainer.Trainer(cfg, device=device).run()


def main(argv=None):
    register_stack_dump()
    parser = argparse.ArgumentParser(description='trainer configuration')
    parser.add_argument('--yaml', default=None)
    parser.add_argument('--device', default='cuda')
    from pqdet_tpu_torch.parallel.mesh import add_dist_args, run_ranks
    add_dist_args(parser)
    args, rest = parser.parse_known_args(argv)
    cfg = load_config(args.yaml, rest)
    run_ranks(_train_rank, cfg, platform_device(cfg, args.device), args.dist_backend)


if __name__ == '__main__':
    main()
