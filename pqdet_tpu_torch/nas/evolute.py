"""Hyper-parameter evolution driver (the port of ``pqdet_tpu/nas/evolute.py``).

Randomly samples augment probabilities and loss hypers (beta(1.5, 1.5) for
probabilities and alphas, a squared normal perturbation for gains), writes
them into the config and into every yolo node's attrs, trains ONE epoch
from the same initial weights each round and logs {hyper, fitness (AP),
telemetry} to JSON. The port's walk reads the yolo attrs on every call
(``model/network.py``), so the injected loss hypers reach the loss. As in
the JAX package a round whose training or eval raises is printed and left
out of the log.

Across ranks (``system.data_devices`` > 1, ``cli/evolute.py`` launching
them) every rank runs the same rounds, as ``nas/search.py`` runs its
candidates: the hypers come from one seed (rank 0's draw, broadcast, for
a ``seed`` of None), the fitness is rank 0's AP, broadcast, a round that
failed on any rank is left out on every rank, and rank 0 alone prints and
writes the log.
"""

from __future__ import annotations

import copy
import json
from typing import Dict

import numpy as np

from pqdet_tpu_torch.nas.search import free_device_memory, shared_failure, shared_seed
from pqdet_tpu_torch.parallel.mesh import is_main
from pqdet_tpu_torch.train.trainer import Trainer, shared_ap

BASE_HYPERS = {
    'hflip_p': 0.5,
    'crop_p': 0.75,
    'color_p': 0.2,
    'mixup_p': 0.5,
    'ignore_thresh': 0.5,
    'bbox_loss_gain': 1.0,
    'conf_loss_gain': 1.0,
    'cls_loss_gain': 1.7,
    'conf_loss_alpha': 0.5,
    'cls_loss_alpha': 0.5,
    'conf_loss_beta': 2.0,
    'cls_loss_beta': 2.0,
}

_P_KEYS = ('hflip_p', 'crop_p', 'color_p', 'mixup_p', 'ignore_thresh',
           'conf_loss_alpha', 'cls_loss_alpha')
_AUGMENT_KEYS = ('hflip_p', 'crop_p', 'color_p', 'mixup_p')
# the hypers written into every yolo node's attrs
LOSS_HYPERS = ('ignore_thresh', 'bbox_loss_gain', 'conf_loss_gain', 'cls_loss_gain',
               'conf_loss_alpha', 'cls_loss_alpha', 'conf_loss_beta', 'cls_loss_beta')


def sample_hypers(rng: np.random.RandomState) -> Dict[str, float]:
    hypers = {}
    for k, base in BASE_HYPERS.items():
        if k == 'conf_loss_beta':
            hypers[k] = 2.0
        elif k == 'cls_loss_beta':
            hypers[k] = float(rng.choice(range(3)))
        elif k in _P_KEYS:
            hypers[k] = float(rng.beta(1.5, 1.5))
        else:  # gains: multiplicative squared-normal perturbation
            hypers[k] = float(base * (rng.randn() * 0.2 + 1.0) ** 2.0)
    return hypers


def inject_loss_hypers(network, hypers: Dict[str, float]):
    """Write the loss hypers into every yolo node's attrs."""
    for node in network.graph.yolo_nodes:
        for k in LOSS_HYPERS:
            node.attrs[k] = hypers[k]


class Evoluter:

    def __init__(self, config, rounds: int = 200,
                 log_path: str = 'evolution.json', seed: int = None, device='cuda'):
        self.base_config = config
        self.rounds = rounds
        self.log_path = log_path
        self.rng = np.random.RandomState(shared_seed(seed))
        self.device = device
        self.records = []
        self._main = is_main()

    def _round_config(self, hypers: Dict[str, float]):
        cfg = copy.deepcopy(self.base_config)
        for k in _AUGMENT_KEYS:
            setattr(cfg.augment, k, hypers[k])
        cfg.train.max_epochs = 1
        cfg.train.warmup_epochs = 0.0
        cfg.train.scheduler = 'step'
        cfg.eval.after = 0
        return cfg

    def _write(self, status: str):
        if not self._main:
            return
        with open(self.log_path, 'w') as fw:
            json.dump({'data': self.records,
                       'exit': {'status': status,
                                'completed_rounds': len(self.records),
                                'target_rounds': self.rounds}}, fw)

    def run(self):
        log = print if self._main else (lambda *args: None)
        for i in range(self.rounds):
            hypers = sample_hypers(self.rng)
            log(i, hypers)
            cfg = self._round_config(hypers)
            trainer = Trainer(cfg, device=self.device)
            # identical init weights every round (build_detector's fixed seed)
            trainer.init_all()
            inject_loss_hypers(trainer.network, hypers)
            error = None
            try:
                trainer.train_epoch(0)
                fitness = shared_ap(trainer)
            except Exception as exc:
                error = str(exc)
            finally:
                # one Trainer per round: release its device memory (the
                # device corpus memo stays for the next round)
                trainer.close()
                free_device_memory(self.device)
            error = shared_failure(error)
            if error is not None:
                log(f'round {i} failed: {error}')
                continue
            log(fitness)
            self.records.append({'hyper': hypers, 'fitness': float(fitness),
                                 'telemetry': _telemetry(self.device)})
            self._write('running')
        self._write('completed')
        return self.records


def _telemetry(device) -> Dict:
    """Per-round memory telemetry, the flight recorder of a run that dies
    without a traceback: the host's RSS, the card's allocated bytes
    (``torch.cuda.memory_allocated``; 0 off the card) and the number of
    objects the collector tracks."""
    import gc

    import torch
    rss_kb = 0
    try:
        with open('/proc/self/status') as f:
            for line in f:
                if line.startswith('VmRSS:'):
                    rss_kb = int(line.split()[1])
                    break
    except OSError:
        pass
    dev = torch.device(device)
    return {'rss_gb': round(rss_kb / 1e6, 2),
            'cuda_allocated': torch.cuda.memory_allocated(dev) if dev.type == 'cuda' else 0,
            'gc_objects': len(gc.get_objects())}
