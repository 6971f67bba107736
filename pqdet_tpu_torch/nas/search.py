"""Random NAS search driver (the port of ``pqdet_tpu/nas/search.py``).

Samples DetNet candidates, filters them by MACs (and, optionally, by their
forward's latency measured on the card), short-trains each through
``Trainer.run_nas`` and appends the result to a JSON log. As in the JAX
package every exception of a candidate's run is caught and logged as
``diverged``, with the step of a ``NaN in loss near step N`` error, and
the log's records read the same in ``nas/analysis.py`` whichever package
wrote them.

Across ranks (``system.data_devices`` > 1, ``cli/search.py`` launching
them) every rank runs the same loop and each candidate trains in the
process group, one ``Trainer`` per candidate. The ranks take every
decision together, or one would wait at a collective the others never
reach: a ``seed`` of None is drawn on rank 0 and broadcast, rank 0 alone
measures the latency and broadcasts it before the filter, rank 0
evaluates and broadcasts the AP (``train.trainer.shared_ap``), and a
candidate that failed on any rank is ``diverged`` on all, with the first
failing rank's error. Rank 0 alone prints and writes the log.
"""

from __future__ import annotations

import gc
import json
import os
import re
import subprocess
import time
import traceback
from typing import Optional

import numpy as np

from pqdet_tpu_torch import resolve_device
from pqdet_tpu_torch.model.graph import Graph
from pqdet_tpu_torch.nas.detnet import detnet_600m
from pqdet_tpu_torch.parallel.mesh import (any_rank, broadcast_object, gather_objects,
                                           is_main, world)
from pqdet_tpu_torch.utils.profiling import count_macs_params

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_device_memory(device):
    """Collect the dropped objects of a finished candidate or round (a
    traceback's frames hold its tensors in cycles) and return the card's
    cached blocks, so the next one starts from the same level."""
    import torch
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()


def measure_latency(cfg_text: str, input_size: int = 512, device='cuda') -> float:
    """p50 ms of the candidate's f32 forward at B=1 on BN-folded params
    (seeded weights), each call after the warm-up timed alone with CUDA
    events on the card (``utils/profiling.py::forward_latency_ms``), what a
    caller waits for one image."""
    import torch
    from pqdet_tpu_torch.model.network import DetectionNetwork, fuse_params
    from pqdet_tpu_torch.utils.profiling import forward_latency_ms

    net = DetectionNetwork.from_cfg(cfg_text)
    params, state = net.init(torch.Generator().manual_seed(0), device=device)
    with torch.inference_mode():
        fused = fuse_params(net, params, state)
        x = torch.zeros(1, input_size, input_size, 3, device=device)
        return forward_latency_ms(lambda: net(fused, {}, x), device)['p50']


def generate_candidates(n: int, max_macs: float = 5e9, min_macs: float = 0.0,
                        max_latency_ms: Optional[float] = None,
                        num_classes: int = 20, seed: Optional[int] = None,
                        exp_cap: float = 40.0, device='cuda'):
    """Yield up to n (cfg_text, info) candidates passing the filters."""
    rng = np.random.RandomState(seed)
    produced = 0
    while produced < n:
        cfg_text, head = detnet_600m(num_classes=num_classes, rng=rng,
                                     return_head=True, exp_cap=exp_cap)
        try:
            graph = Graph.from_cfg(cfg_text)
        except Exception:
            continue
        macs, params = count_macs_params(graph, (512, 512))
        if not (min_macs <= macs <= max_macs):
            continue
        info = {'macs': macs, 'params': params, 'head': head}
        if max_latency_ms is not None:
            # measured once, on rank 0: every rank filters on the same number
            latency = broadcast_object(measure_latency(cfg_text, device=device)
                                       if is_main() else None)
            if latency > max_latency_ms:
                continue
            info['latency_ms'] = latency
        produced += 1
        yield cfg_text, info


def _log_meta(rounds, max_macs, max_latency_ms, seed, exp_cap):
    try:
        commit = subprocess.run(
            ['git', 'rev-parse', '--short', 'HEAD'], cwd=REPO,
            capture_output=True, text=True).stdout.strip()
    except OSError:
        commit = None
    return {'driver': 'pqdet_tpu_torch/nas/search.py', 'rounds': rounds,
            'max_macs': max_macs, 'max_latency_ms': max_latency_ms,
            'seed': seed, 'exp_cap': exp_cap, 'commit': commit,
            'date': time.strftime('%Y-%m-%d %H:%M UTC', time.gmtime())}


def shared_seed(seed: Optional[int]) -> Optional[int]:
    """``seed``, or at world size > 1 for a ``seed`` of None one drawn on
    rank 0 and broadcast, so that every rank samples the same candidates
    or hypers (one process keeps None: fresh OS entropy, as JAX)."""
    if seed is not None or world() == 1:
        return seed
    return broadcast_object(int(np.random.randint(2 ** 31)) if is_main() else None)


def shared_failure(error: Optional[str]) -> Optional[str]:
    """The first failing rank's error (``error`` is this rank's, None when
    it did not fail), the same on every rank; None when no rank failed."""
    if not any_rank(error is not None):
        return None
    return next(e for e in gather_objects(error) if e is not None)


def search(config, rounds: int = 50, max_macs: float = 5e9,
           log_path: str = 'nas_search.json',
           max_latency_ms: Optional[float] = None,
           seed: Optional[int] = None, exp_cap: float = 40.0, device='cuda'):
    """Short-train candidates and log every sampled one: {cfg, macs,
    params, head, latency_ms?, status, ap} per round, a diverged candidate
    with ``status='diverged'``, ``ap=None``, its step of death and the
    error, so the EDF analysis sees an unbiased sample. Appends to the
    records of an existing log. A ``device`` this machine lacks raises
    here, before the first candidate (it would be logged as diverged).
    Across ranks: the module docstring."""
    from pqdet_tpu_torch.train.trainer import Trainer

    resolve_device(device)
    main = is_main()
    records = []
    if main and os.path.exists(log_path):
        with open(log_path) as fr:
            records = json.load(fr).get('data', [])

    for i, (cfg_text, info) in enumerate(
            generate_candidates(rounds, max_macs=max_macs,
                                max_latency_ms=max_latency_ms,
                                num_classes=len(config.dataset.classes),
                                seed=shared_seed(seed), exp_cap=exp_cap, device=device)):
        if main:
            print(f'=== candidate {i}: {info}')
        rec = {'cfg': cfg_text, **info}
        error = None
        try:
            trainer = Trainer(config, device=device)
            ap = trainer.run_nas(cfg_text)
        except Exception as e:
            traceback.print_exc()
            error = str(e)
        finally:
            free_device_memory(device)
        error = shared_failure(error)
        if error is None:
            rec.update(status='completed', ap=float(ap))
        else:
            m = re.search(r'near step (\d+)', error)
            rec.update(status='diverged', ap=None,
                       step_of_death=int(m.group(1)) if m else None,
                       error=error[:800])
        records.append(rec)
        if main:
            with open(log_path, 'w') as fw:
                json.dump({'meta': _log_meta(rounds, max_macs, max_latency_ms,
                                             seed, exp_cap),
                           'data': records}, fw)
            print(f'candidate {i}: {rec["status"]} AP={rec["ap"]}')
    return records
