"""Visualisation/debug helpers (the port of ``pqdet_tpu/utils/draw.py``;
reference draw.py: BN-gamma scatter, pruned-channel bars, evolution
scatter) on checkpoints of either package, which share one format
(``utils/codec.py``: numpy arrays in the JAX package's layout). matplotlib
is imported inside each function."""

from __future__ import annotations

import json
from typing import List, Optional, Sequence

import numpy as np


def _sorted_bn_gammas(ckpt) -> np.ndarray:
    gammas = []
    for layer in ckpt['params'].values():
        if isinstance(layer, dict) and 'bn' in layer:
            gammas.append(np.abs(np.asarray(layer['bn']['gamma'])).ravel())
    return np.sort(np.concatenate(gammas))


def draw_bn_scatter(weights: Sequence[str], labels: Optional[Sequence[str]] = None,
                    save_path: str = 'bn_scatter.png'):
    """Sorted |gamma| distributions of one or more checkpoints — the
    sparse-training progress view."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from pqdet_tpu_torch.utils.codec import load_checkpoint

    fig, ax = plt.subplots(figsize=(8, 4))
    colors = ['b', 'g', 'r', 'c', 'm', 'y']
    labels = labels or [None] * len(weights)
    for path, color, label in zip(weights, colors, labels):
        bns = _sorted_bn_gammas(load_checkpoint(path))
        xs = np.arange(len(bns)) / max(len(bns) - 1, 1)
        ax.scatter(xs, bns, s=25, c=color, alpha=0.5, label=label)
    ax.set_xlabel('fraction of channels')
    ax.set_ylabel('|BN gamma|')
    if any(labels):
        ax.legend()
    fig.savefig(save_path, bbox_inches='tight')
    return save_path


def draw_prune_bars(before_ckpt: str, after_ckpt: str,
                    save_path: str = 'prune_bars.png'):
    """Per-layer channel counts before/after pruning."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    from pqdet_tpu_torch.utils.codec import load_checkpoint

    def channels(ckpt):
        out = {}
        for key, layer in ckpt['params'].items():
            if isinstance(layer, dict) and 'w' in layer \
                    and np.asarray(layer['w']).ndim == 4:
                out[int(key)] = np.asarray(layer['w']).shape[3]
        return out

    c0 = channels(load_checkpoint(before_ckpt))
    c1 = channels(load_checkpoint(after_ckpt))
    idx = sorted(c0)
    fig, ax = plt.subplots(figsize=(12, 4))
    ax.bar([i - 0.2 for i in idx], [c0[i] for i in idx], width=0.4,
           label='before')
    ax.bar([i + 0.2 for i in idx], [c1.get(i, 0) for i in idx], width=0.4,
           label='after')
    ax.set_xlabel('layer index')
    ax.set_ylabel('channels')
    ax.legend()
    fig.savefig(save_path, bbox_inches='tight')
    return save_path


def draw_evolution(log_path: str, keys: Optional[List[str]] = None,
                   save_path: str = 'evolution.png'):
    """Scatter hyper value vs fitness per hyper key (reference
    draw.py:90-99)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    with open(log_path) as fr:
        records = json.load(fr)['data']
    if not records:
        raise ValueError('empty evolution log')
    keys = keys or sorted(records[0]['hyper'])
    n = len(keys)
    cols = min(n, 4)
    rows = (n + cols - 1) // cols
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 3 * rows),
                             squeeze=False)
    for i, key in enumerate(keys):
        ax = axes[i // cols][i % cols]
        ax.scatter([r['hyper'][key] for r in records],
                   [r['fitness'] for r in records], s=16, alpha=0.6)
        ax.set_xlabel(key)
        ax.set_ylabel('AP')
    fig.tight_layout()
    fig.savefig(save_path, bbox_inches='tight')
    return save_path
