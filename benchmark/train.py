"""Training cells: the port's train step (``train/step.py``'s
``train_step_from_config``) stepped back to back over a pool of batches on
the device, as the trainer calls it.

Set-up builds the step, its params and Adam's state once, drives them
through the first three steps on three distinct batches (the check's
steps), and hands the same objects on to the window.
"""

from __future__ import annotations

import statistics
import time
from typing import Dict, List

import torch

from . import compare, weights
from .reference import cfg as C
from .reference import net as RN
from .reference import train as RT

CHECK_STEPS = 3


def make_pool(t: Dict, classes: int, gen: torch.Generator, device) -> List[Dict]:
    """``t['pool']`` batches: ``t['batch']`` uint8 noise images and their GT
    boxes, 1 to ``t['gt_max_drawn']`` an image padded to ``t['max_gt']``
    rows, sides from 8 px to half the image, centres inside it, mixup
    weight 1."""
    b, s, g, k = t['batch'], t['size'], t['max_gt'], t['gt_max_drawn']
    pool = []
    for _ in range(t['pool']):
        img = torch.randint(0, 256, (b, s, s, 3), generator=gen, device=device,
                            dtype=torch.uint8)
        n = torch.randint(1, k + 1, (b, 1), generator=gen, device=device)
        c = torch.rand(b, k, 2, generator=gen, device=device) * s
        wh = 8 + torch.rand(b, k, 2, generator=gen, device=device) * (s / 2 - 8)
        cls = torch.randint(0, classes, (b, k, 1), generator=gen, device=device).float()
        rows = torch.cat([(c - wh / 2).clamp(0, s), (c + wh / 2).clamp(0, s), cls,
                          torch.ones(b, k, 1, device=device)], -1)
        rows = rows * (torch.arange(k, device=device)[None, :] < n)[..., None]
        gt = torch.zeros(b, g, 6, device=device)
        gt[:, :k] = rows
        pool.append({'image': img, 'gt': gt})
    return pool


class Train:
    """One training cell: ``setup``, ``window``, ``free``, ``check``."""

    def __init__(self, cell: Dict, seed_gen, device, tracer):
        self.cell, self.t, self.device, self.tracer = cell, cell['traffic'], device, tracer
        self.lays = C.layers(cell['cfg_text'])
        self.gens = seed_gen
        self.classes = cell['config']['classes']

    def program_config(self):
        from pqdet_tpu_torch.config import Config
        t = self.t
        cfg = Config()
        cfg.train.batch_size = t['batch']
        cfg.train.input_sizes = [t['size']]
        cfg.train.learning_rate_init = cfg.train.learning_rate_end = t['learning_rate']
        cfg.train.warmup_epochs = t['warmup_epochs']
        cfg.train.remat = t['remat']
        cfg.model.max_gt_boxes = t['max_gt']
        cfg.model.strides = list(t['strides'])
        cfg.model.anchors = [list(a) for a in t['anchors']]
        cfg.augment.device = False
        cfg.system.compute_dtype = t['compute_dtype']
        return cfg

    def prepare_inputs(self):
        self.pool = make_pool(self.t, self.classes, self.gens('pool'), self.device)

    def setup(self):
        from pqdet_tpu_torch.model.network import DetectionNetwork
        from pqdet_tpu_torch.train.step import train_step_from_config
        t, dev = self.t, self.device
        params, state = weights.make(self.lays, self.gens('weights'),
                                     self.cell['config']['gain'], dev)
        self.prepare_inputs()
        net = DetectionNetwork.from_cfg(self.cell['cfg_text'])
        step, opt = train_step_from_config(net, self.program_config(),
                                           steps_per_epoch=t['steps_per_epoch'], device=dev)
        self.step = self.tracer.wrap('train.step', step)
        opt_state = opt.init(params)
        self.first = {'params': params, 'state': state, 'loss': []}
        for k in range(CHECK_STEPS):
            params, state, opt_state, m = self.step(params, state, opt_state, self.pool[k])
            self.first['loss'].append(float(m['loss']))
            if k == 0:
                self.first['mu'] = opt_state['mu'].clone()
                self.first['state1'] = state
        self.first['after'] = (params, state)
        self.live = [params, state, opt_state]
        self.done = CHECK_STEPS
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    def window(self, seconds: float) -> Dict:
        params, state, opt_state = self.live
        pool, step, dev = self.pool, self.step, self.device
        if dev.type == 'cuda':
            torch.cuda.reset_peak_memory_stats(dev)
        n = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            params, state, opt_state, _ = step(params, state, opt_state,
                                               pool[(self.done + n) % len(pool)])
            n += 1
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
        out = {'train_images_per_s': n * self.t['batch'] / wall, 'steps': n,
               'images': n * self.t['batch'], 'wall_s': wall}
        if dev.type == 'cuda':
            out['train_peak_mem_gib'] = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        self.live = [params, state, opt_state]
        self.done += n
        return out

    def counters(self) -> Dict[str, int]:
        return {}

    def free(self):
        self.step = self.live = None
        self.pool = self.pool[:CHECK_STEPS]

    # --------------------------------------------------------- reference
    def lr(self, k: int) -> float:
        """The rate of update k: a linear warm-up over max(1, warm-up steps)
        updates, then the traffic's constant rate."""
        t = self.t
        warm = max(int(t['warmup_epochs'] * t['steps_per_epoch']), 1)
        return t['learning_rate'] * min(k / warm, 1.0)

    def reference_steps(self, lowp=None) -> Dict:
        params, state = weights.make(self.lays, self.gens('weights'),
                                     self.cell['config']['gain'], self.device)
        start = (RT.leaves(params), RT.leaves(state))
        model = {'strides': self.t['strides'], 'anchors': self.t['anchors'],
                 'classes': self.classes}
        adam = RT.Adam(params)
        losses, first, state1 = [], None, None
        with RN.no_tf32():
            for k in range(CHECK_STEPS):
                b = self.pool[k]
                loss, grads, new_state = RT.loss_and_grads(self.lays, params, state, b['image'],
                                                           b['gt'], model, lowp)
                losses.append(float(loss))
                first = grads if first is None else first
                params = adam.step(params, grads, self.lr(k))
                state = {**state, **new_state}
                state1 = RT.leaves(state) if state1 is None else state1
        return {'loss': losses, 'grad': first, 'start': start, 'state1': state1,
                'after': (RT.leaves(params), RT.leaves(state))}

    @staticmethod
    def numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
        """``compare``'s training numbers of ``prog`` (the program's or the
        control's readings, in ``reference_steps``' form) against ``ref``.
        Leaves whose reference gradient is quiet (``compare.quiet_leaves``)
        are left out of every number but ``grad_gap_all``."""
        quiet = compare.quiet_leaves(ref['grad'])
        loss = max(abs(a - b) / abs(b) for a, b in zip(prog['loss'], ref['loss']))
        grad = compare.leaf_gaps(prog['grad'], ref['grad'], quiet)
        start = ref['start'][0] + ref['start'][1]
        p_after, r_after = (r['after'][0] + r['after'][1] for r in (prog, ref))
        loud = [i for i in range(len(start)) if i not in quiet]
        bn = compare.state_gaps(prog['state1'], ref['state1'], ref['start'][1])
        moved = compare.state_gaps([p_after[i] for i in loud], [r_after[i] for i in loud],
                                   [start[i] for i in loud])
        change = compare.leaf_gaps([a - s for a, s in zip(p_after, start)],
                                   [a - s for a, s in zip(r_after, start)], quiet)
        return {'loss_gap': loss, 'grad_gap': statistics.median(grad),
                'grad_gap_worst': max(grad),
                'grad_gap_all': max(compare.leaf_gaps(prog['grad'], ref['grad'])),
                'bn_gap': statistics.median(bn), 'bn_gap_worst': max(bn),
                'change_gap': max(change), 'change_dir': statistics.median(moved),
                'change_dir_worst': max(moved)}

    def program_readings(self) -> Dict:
        f = self.first
        leaves = RT.leaves(f['params'])
        grad = torch.split(f['mu'] / (1 - 0.9), [x.numel() for x in leaves])
        return {'loss': f['loss'], 'grad': [g.view(x.shape) for g, x in zip(grad, leaves)],
                'start': (leaves, RT.leaves(f['state'])), 'state1': RT.leaves(f['state1']),
                'after': (RT.leaves(f['after'][0]), RT.leaves(f['after'][1]))}

    def check(self, sample_gen=None) -> Dict[str, float]:
        return self.numbers(self.program_readings(), self.reference_steps())

    def control(self, lowp: str) -> Dict[str, float]:
        return self.numbers(self.reference_steps(lowp), self.reference_steps())
