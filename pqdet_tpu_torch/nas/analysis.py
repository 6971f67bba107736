"""Post-hoc analysis of NAS search logs: EDFs, AUC comparisons, and
design-space narrowing.

The port of ``pqdet_tpu/nas/analysis.py`` (numpy; matplotlib is imported
only by the drawing function), counterpart of the reference's nas/draw.py
(get_nas_records:7, compute_auc:16, compute_EDF:21, draw_EDF:28,
compare_EDF:35, search_channels:55, attribute filters:96-140), re-keyed to
this repo's record schema (both packages' nas/search.py log {'cfg', 'ap',
'macs', 'params', 'latency_ms'?, 'head': {'widths', 'depth', 'group_ws'}}).

The empirical distribution function (EDF) over candidate errors
(1 - AP) summarises a design (sub)space: for each error level, the
fraction of sampled candidates at or below it. Comparing the AUC of a
filtered subspace against the full space (RegNet methodology) tells
whether a constraint improves the space rather than one lucky sample.

    python -m pqdet_tpu_torch.nas.analysis nas_search.json --out results/
"""

from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

Records = Sequence[Dict]


def load_records(path: str) -> List[Dict]:
    """Read a nas/search.py JSON log (reference get_nas_records).
    Diverged candidates (status='diverged', ap=None — logged since round
    5 so the sample is unbiased on disk) carry no AP and are excluded
    from EDF/AUC math; count them separately via load_all_records."""
    with open(path) as fr:
        data = json.load(fr)['data']
    return [r for r in data if r.get('ap') is not None]


def load_all_records(path: str) -> List[Dict]:
    """Every sampled candidate, including divergences."""
    with open(path) as fr:
        return json.load(fr)['data']


def best_record(records: Records) -> Dict:
    """Highest-AP record (reference _print_best, nas/draw.py:12)."""
    return max(records, key=lambda r: r['ap'])


def compute_edf(records: Records) -> Tuple[np.ndarray, np.ndarray]:
    """(sorted errors, cumulative probabilities); error = 1 - AP
    (reference compute_EDF, nas/draw.py:21-26)."""
    errors = np.sort(1.0 - np.array([r['ap'] for r in records]))
    probs = np.arange(1, len(errors) + 1) / len(errors)
    return errors, probs


def compute_auc(errors: np.ndarray, probs: np.ndarray) -> float:
    """Area under the EDF over the error axis [0, 1]; higher = better
    space (reference compute_auc, nas/draw.py:16-19)."""
    x = np.concatenate(([0.0], errors, [1.0]))
    y = np.concatenate(([0.0], probs))
    return float(np.sum(np.diff(x) * y))


# ----------------------------------------------------------- filters

def ap_filter(lo: float = 0.0, hi: float = 1.0) -> Callable[[Dict], bool]:
    return lambda r: lo <= r['ap'] <= hi


def macs_filter(lo: float, hi: float) -> Callable[[Dict], bool]:
    """reference _macs_filter (nas/draw.py:109)."""
    return lambda r: lo < r['macs'] < hi


def latency_filter(lo: float, hi: float) -> Callable[[Dict], bool]:
    """reference _time_filter (nas/draw.py:116); records without a
    measured latency are excluded."""
    return lambda r: ('latency_ms' in r and lo < r['latency_ms'] < hi)


def depth_filter(lo: int, hi: int) -> Callable[[Dict], bool]:
    """reference _d_filter (nas/draw.py:96)."""
    return lambda r: lo <= r['head']['depth'] <= hi


def width_filter(lo, hi) -> Callable[[Dict], bool]:
    """Per-branch head-width window (reference _channel_filter,
    nas/draw.py:133-140); lo/hi are scalars or 3-sequences."""
    lo = [lo] * 3 if np.isscalar(lo) else list(lo)
    hi = [hi] * 3 if np.isscalar(hi) else list(hi)

    def fltr(r):
        ws = r['head']['widths']
        return all(lo[i] <= ws[i] <= hi[i] for i in range(3))
    return fltr


def invert(f: Callable[[Dict], bool]) -> Callable[[Dict], bool]:
    """reference _reverse_filter (nas/draw.py:130)."""
    return lambda r: not f(r)


# ---------------------------------------------------------- analyses

def compare_edf(records: Records, flt: Callable[[Dict], bool]
                ) -> Dict[str, float]:
    """AUC(filtered subspace) - AUC(full space) (reference compare_EDF,
    nas/draw.py:35-53). Positive delta: the constraint improves the
    space."""
    sub = [r for r in records if flt(r)]
    if not sub:
        return {'auc_sub': 0.0, 'auc_all': compute_auc(*compute_edf(records)),
                'delta': float('-inf'), 'n_sub': 0, 'n_all': len(records)}
    auc_sub = compute_auc(*compute_edf(sub))
    auc_all = compute_auc(*compute_edf(records))
    return {'auc_sub': auc_sub, 'auc_all': auc_all,
            'delta': auc_sub - auc_all, 'n_sub': len(sub),
            'n_all': len(records)}


def search_width_windows(records: Records, step: int = 24,
                         min_fraction: float = 1 / 3,
                         max_fraction: float = 2 / 3) -> List[Tuple]:
    """Scan head-width windows for the largest positive AUC delta vs the
    complement (reference search_channels, nas/draw.py:55-94): windows
    keeping between min/max_fraction of the samples, scored by
    AUC(inside) - AUC(outside), best first."""
    ws = np.array([r['head']['widths'] for r in records])  # (N, 3)
    results = []
    for i in range(3):
        # grid spans floor(min) .. ceil(max) in step units so the widest
        # widths are inside candidate windows too
        lo_grid = np.arange(ws[:, i].min() // step * step,
                            -(-ws[:, i].max() // step) * step + 1, step)
        for lo in lo_grid:
            for hi in lo_grid[lo_grid > lo]:
                flt = lambda r, i=i, lo=lo, hi=hi: \
                    lo <= r['head']['widths'][i] <= hi
                sub = [r for r in records if flt(r)]
                if not (min_fraction * len(records) <= len(sub)
                        <= max_fraction * len(records)):
                    continue
                out = [r for r in records if not flt(r)]
                delta = (compute_auc(*compute_edf(sub))
                         - compute_auc(*compute_edf(out)))
                if delta > 0:
                    results.append((delta, i, int(lo), int(hi), len(sub)))
    return sorted(results, reverse=True)


def draw_edf(records_sets, labels, path: str):
    """Overlay EDF curves for several record sets (reference draw_EDF /
    compare_EDF plots)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(6, 4))
    for recs, label in zip(records_sets, labels):
        errors, probs = compute_edf(recs)
        auc = compute_auc(errors, probs)
        ax.plot(errors, probs, marker='*', markersize=3,
                label=f'{label} (n={len(recs)}, AUC={auc:.3f})')
    ax.set_xlabel('error (1 - AP)')
    ax.set_ylabel('cumulative probability')
    ax.legend()
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path


def main(argv=None):
    import argparse
    import os
    parser = argparse.ArgumentParser(description='NAS log EDF analysis')
    parser.add_argument('log')
    parser.add_argument('--out', default='results')
    parser.add_argument('--width-step', type=int, default=24)
    args = parser.parse_args(argv)

    records = load_records(args.log)
    print(f'{len(records)} records; best: AP={best_record(records)["ap"]:.4f}')
    os.makedirs(args.out, exist_ok=True)
    draw_edf([records], ['all'], os.path.join(args.out, 'EDF.png'))

    windows = search_width_windows(records, step=args.width_step)
    if windows:
        delta, i, lo, hi, n = windows[0]
        print(f'best width window: branch {i} in [{lo}, {hi}] '
              f'(n={n}, AUC delta {delta:+.4f})')
        flt = lambda r: lo <= r['head']['widths'][i] <= hi
        draw_edf([records, [r for r in records if flt(r)]],
                 ['all', f'w{i} in [{lo},{hi}]'],
                 os.path.join(args.out, 'compare_EDF.png'))
    else:
        print('no width window improves the space')


if __name__ == '__main__':
    main()
