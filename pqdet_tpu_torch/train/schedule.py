"""Learning-rate schedules as plain functions of the int update count (the
port of ``pqdet_tpu/train/schedule.py``): linear warmup to ``init_lr``,
then a cosine anneal to ``end_lr`` or a milestone step decay. The optimizer
calls the schedule with the count of updates made before the one at hand,
so update 0 of a warmup has lr 0."""

from __future__ import annotations

import math
from typing import Sequence


def cosine_warmup(init_lr: float, end_lr: float, warmup_steps: int, max_steps: int):
    warmup_steps = max(warmup_steps, 1)

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return step / warmup_steps * init_lr
        progress = (step - warmup_steps) / max(max_steps - warmup_steps, 1)
        return end_lr + 0.5 * (init_lr - end_lr) * (1 + math.cos(progress * math.pi))

    return schedule


def step_decay_warmup(init_lr: float, warmup_steps: int, steps_per_epoch: int,
                      mile_stones: Sequence[int], gamma: float):
    warmup_steps = max(warmup_steps, 1)
    boundaries = [m * steps_per_epoch for m in mile_stones]

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return step / warmup_steps * init_lr
        decayed = init_lr
        for i, b in enumerate(boundaries):
            if step >= b:
                decayed = init_lr * gamma ** (i + 1)
        return decayed

    return schedule


def build_schedule(cfg, steps_per_epoch: int):
    """The schedule of the ``train`` config group."""
    warmup = int(cfg.train.warmup_epochs * steps_per_epoch)
    if cfg.train.scheduler == 'cosine':
        return cosine_warmup(cfg.train.learning_rate_init, cfg.train.learning_rate_end,
                             warmup, cfg.train.max_epochs * steps_per_epoch)
    if cfg.train.scheduler == 'step':
        return step_decay_warmup(cfg.train.learning_rate_init, warmup, steps_per_epoch,
                                 cfg.train.mile_stones, cfg.train.gamma)
    raise ValueError(f'unknown scheduler: {cfg.train.scheduler}')
