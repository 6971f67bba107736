"""Network-slimming channel pruner (the port of ``pqdet_tpu/compress/prune.py``).

Works on the graph IR and the port's (params, state) and re-emits a pruned
cfg, with the JAX package's masking rules:

- global threshold: the ``prune_ratio`` quantile of all |BN gamma| over the
  conv+BN layers, ``flat[int(len(flat) * ratio)]`` of the sorted values;
  ``prune_limit`` is the share of them below the smallest per-layer maximum
- a conv+BN keeps its top-|gamma| channels (a stable argsort of -|gamma|,
  so ties keep the lower index), the count rounded up to a multiple of 8
  with a floor of 16
- a depthwise conv inherits its input mask, and its groups follow it; a
  grouped conv that is not depthwise raises ``ValueError``
- shortcut members keep every output (their inputs are still pruned) and
  their masks must agree
- the SE expand conv feeding a scale_channels takes the mask of the scale
  target
- bias-only convs (heads) keep every output channel
- a route concatenates its inputs' masks

Conv weights are OIHW here (out axis 0, in axis 1; the JAX package slices
HWIO axes 3 and 2). The masks are numpy on the host; the weights are
sliced on the device they came in on.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from pqdet_tpu_torch.model.cfgparse import emit_cfg
from pqdet_tpu_torch.model.graph import Graph


class PruneResult:
    def __init__(self, cfg_text: str, params: Dict, state: Dict,
                 report: List[str], prune_limit: float):
        self.cfg_text = cfg_text
        self.params = params
        self.state = state
        self.report = report
        self.prune_limit = prune_limit


def _take(t: torch.Tensor, mask, dim: int = 0) -> torch.Tensor:
    """The entries of ``t`` along ``dim`` where the numpy bool ``mask`` holds
    (all of them, copied, for ``slice(None)``)."""
    if isinstance(mask, slice):
        return t.clone()
    idx = torch.from_numpy(np.flatnonzero(mask)).to(t.device)
    return t.index_select(dim, idx)


def _abs_gamma(p: Dict) -> np.ndarray:
    return np.abs(p['bn']['gamma'].detach().to('cpu', torch.float32).numpy())


def prune_slimming(graph: Graph, params: Dict, state: Dict,
                   prune_ratio: float) -> PruneResult:
    nodes = graph.nodes

    # pre-pass: keep_out (shortcut members) and SE constraints
    keep_out = set()
    constrain = {}  # conv node index -> node index whose mask it must match
    for n in nodes:
        if n.kind == 'shortcut':
            keep_out.add(n.refs[0])
            keep_out.add(n.index - 1)
        elif n.kind == 'scale_channels':
            constrain[n.index - 1] = n.refs[0]

    # global threshold over |gamma| of all conv+BN layers
    gammas, max_per_layer = [], []
    for n in nodes:
        if n.kind == 'convolutional' and n.has_bn:
            g = _abs_gamma(params[str(n.index)])
            gammas.append(g)
            max_per_layer.append(g.max())
    flat = np.sort(np.concatenate(gammas))
    prune_limit = float(np.searchsorted(flat, min(max_per_layer)) / len(flat))
    report = [f'prune limit: {prune_limit}']
    if prune_ratio > prune_limit:
        report.append('the layer reached prune limit will be cast to 16 channels.')
    threshold = flat[int(len(flat) * prune_ratio)]

    out_mask: Dict[int, np.ndarray] = {}
    new_params: Dict[str, dict] = {}
    new_state: Dict[str, dict] = {}
    new_layers: List[dict] = [{'name': 'net', 'channels': graph.in_channels}]

    def _mask_bn(idx: str, mask) -> None:
        p = params[idx]
        new_params[idx]['bn'] = {'gamma': _take(p['bn']['gamma'], mask),
                                 'beta': _take(p['bn']['beta'], mask)}
        new_state[idx] = {'mean': _take(state[idx]['mean'], mask),
                          'var': _take(state[idx]['var'], mask)}

    for n in nodes:
        idx = str(n.index)
        attrs = dict(n.attrs)
        attrs.pop('stride_out', None)
        if n.kind == 'convolutional':
            in_mask = out_mask[n.index - 1] if n.index > 0 \
                else np.ones(n.in_channels, bool)
            w = params[idx]['w']  # OIHW
            pruned = 0

            if n.index in constrain and not n.has_bn:
                cmask = out_mask[constrain[n.index]]
                new_params[idx] = {'w': _take(_take(w, in_mask, 1), cmask),
                                   'b': _take(params[idx]['b'], cmask)}
                out_mask[n.index] = cmask
                pruned = int(len(cmask) - cmask.sum())
            elif not n.has_bn:
                new_params[idx] = {'w': _take(w, in_mask, 1),
                                   'b': params[idx]['b'].clone()}
                out_mask[n.index] = np.ones(w.shape[0], bool)
            elif n.attrs['groups'] > 1:
                if n.attrs['groups'] != n.in_channels:
                    raise ValueError(
                        f'layer {n.index}: only depthwise grouped convs '
                        f'can be pruned')
                new_params[idx] = {'w': _take(w, in_mask)}
                _mask_bn(idx, in_mask)
                out_mask[n.index] = in_mask
                attrs['groups'] = int(in_mask.sum())
            elif n.index in keep_out:
                new_params[idx] = {'w': _take(w, in_mask, 1)}
                _mask_bn(idx, slice(None))
                out_mask[n.index] = np.ones(w.shape[0], bool)
            else:
                g = _abs_gamma(params[idx])
                n_keep = int(np.sum(g > threshold))
                n_keep = max(16, ((n_keep + 7) // 8) * 8)
                picked = np.argsort(-g, kind='stable')[:n_keep]
                mask = np.zeros(len(g), bool)
                mask[picked] = True
                new_params[idx] = {'w': _take(_take(w, in_mask, 1), mask)}
                _mask_bn(idx, mask)
                out_mask[n.index] = mask
                pruned = int(len(g) - mask.sum())

            attrs['filters'] = int(out_mask[n.index].sum())
            report.append(f'({n.index}){n.kind}: {pruned}/'
                          f'{len(out_mask[n.index])} pruned')
        elif n.kind == 'shortcut':
            m1, m2 = out_mask[n.refs[0]], out_mask[n.index - 1]
            if not np.array_equal(m1, m2):
                raise ValueError(f'shortcut {n.index}: member masks differ')
            out_mask[n.index] = m1
            report.append(f'({n.index}){n.kind}: 0/{len(m1)} pruned')
        elif n.kind == 'route':
            out_mask[n.index] = np.concatenate([out_mask[r] for r in n.refs])
            report.append(f'({n.index}){n.kind}: 0/{len(out_mask[n.index])} pruned')
        elif n.kind == 'scale_channels':
            out_mask[n.index] = out_mask[n.refs[0]]
            report.append(f'({n.index}){n.kind}: 0/{len(out_mask[n.index])} pruned')
        elif n.kind == 'fc':
            new_params[idx] = {'w': params[idx]['w'].clone(),
                               'b': params[idx]['b'].clone()}
            out_mask[n.index] = np.ones(n.out_channels, bool)
        else:  # maxpool / avgpool / upsample / yolo / dropout
            prev = out_mask.get(n.index - 1)
            out_mask[n.index] = prev if prev is not None \
                else np.ones(n.out_channels, bool)
            report.append(f'({n.index}){n.kind}: 0/{len(out_mask[n.index])} pruned')

        # drop keys the cfg emitter rebuilds from structure
        if n.kind == 'yolo':
            attrs.pop('stride', None)
        new_layers.append(attrs)

    cfg_text = emit_cfg(new_layers)
    # structural check: the pruned cfg must rebuild into a graph whose
    # shapes match the pruned params
    pruned_graph = Graph.from_cfg(cfg_text)
    for n in pruned_graph.nodes:
        if n.kind == 'convolutional':
            w = new_params[str(n.index)]['w']
            if w.shape[0] != n.attrs['filters']:
                raise AssertionError(f'layer {n.index}: emitted filters mismatch')
            if w.shape[1] != n.in_channels // n.attrs['groups']:
                raise AssertionError(f'layer {n.index}: emitted in_channels mismatch')
    return PruneResult(cfg_text, new_params, new_state, report, prune_limit)
