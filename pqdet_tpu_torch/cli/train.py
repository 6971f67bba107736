"""Training CLI (the port of ``pqdet_tpu/cli/train.py``).

    python -m pqdet_tpu_torch.cli.train --yaml yamls/shapes.yaml \
        [--device cuda|cpu] [key value ...]

Trailing ``key value`` pairs override the yaml (dotted keys, e.g.
``train.max_epochs 3``); ``system.platform cpu`` runs on the CPU whatever
``--device`` says. ``kill -USR1 <pid>`` prints every thread's stack.
"""

import argparse

from pqdet_tpu_torch.config import load_config
from pqdet_tpu_torch.utils.debug import register_stack_dump


def main(argv=None):
    register_stack_dump()
    parser = argparse.ArgumentParser(description='trainer configuration')
    parser.add_argument('--yaml', default=None)
    parser.add_argument('--device', default='cuda')
    args, rest = parser.parse_known_args(argv)
    cfg = load_config(args.yaml, rest)
    print(cfg)
    # imported here: with system.loader process the spawned workers import
    # this module as their main one, and need neither torch nor the trainer
    from pqdet_tpu_torch.train import trainer
    trainer.Trainer(cfg, device=args.device).run()


if __name__ == '__main__':
    main()
