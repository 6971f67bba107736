"""MACs and params over the graph IR (the port of
``pqdet_tpu/utils/profiling.py``, thop's convention), a timer of a forward
(CUDA events on the card) and a ``torch.profiler`` trace."""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Callable, Dict, Tuple

import numpy as np

from pqdet_tpu_torch.model.graph import Graph, solve_padding


def count_macs_params(graph: Graph, input_size: Tuple[int, int]) -> Tuple[int, int]:
    """Multiply-accumulates + parameter count for one forward at the given
    (h, w). Convention matches thop: convs count k*k*cin/groups MACs per
    output element; BN/activation/pool are free; linear counts in*out."""
    h, w = input_size
    sizes = {}   # node index -> (h, w)
    macs = 0
    params = 0
    cur = (h, w)
    for node in graph.nodes:
        a = node.attrs
        if node.kind == 'convolutional':
            pad = solve_padding(a['size'], a['padding'], a['pad'])
            oh = (cur[0] + 2 * pad - a['size']) // a['stride'] + 1
            ow = (cur[1] + 2 * pad - a['size']) // a['stride'] + 1
            cur = (oh, ow)
            k2cin = a['size'] * a['size'] * node.in_channels // a['groups']
            macs += oh * ow * a['filters'] * k2cin
            params += a['filters'] * k2cin
            if node.has_bn:
                # thop parity: affine BatchNorm2d counts 4 ops per element
                macs += 4 * oh * ow * a['filters']
                params += 2 * a['filters']
            else:
                params += a['filters']
        elif node.kind == 'fc':
            macs += a['input'] * a['output']
            params += a['input'] * a['output'] + a['output']
            cur = (1, 1)
        elif node.kind == 'maxpool':
            pad = solve_padding(a['size'], a['padding'], a['pad'])
            cur = ((cur[0] + 2 * pad - a['size']) // a['stride'] + 1,
                   (cur[1] + 2 * pad - a['size']) // a['stride'] + 1)
        elif node.kind == 'avgpool':
            # thop parity: adaptive avg pool counts 1 op per input element
            macs += cur[0] * cur[1] * node.in_channels
            cur = node.out_size
        elif node.kind == 'upsample':
            cur = (cur[0] * a['stride'], cur[1] * a['stride'])
        elif node.kind in ('shortcut', 'scale_channels', 'route'):
            cur = sizes[node.refs[0]]
        sizes[node.index] = cur
    return macs, params


def clever_format(n: float) -> str:
    for suffix, scale in (('G', 1e9), ('M', 1e6), ('K', 1e3)):
        if n >= scale:
            return f'{n / scale:.3f}{suffix}'
    return str(n)


def forward_latency_ms(fn: Callable[[], object], device, warmup: int = 10,
                       iters: int = 64) -> Dict[str, float]:
    """ms per call of ``fn``: ``warmup`` calls, then each of ``iters``
    calls timed alone, what a caller waits for a call, its launches
    included. On the card: two CUDA events around each call on the current
    stream, waited for one by one; on the CPU: the host clock. Returns
    {'mean', 'p50', 'p90'}."""
    import torch
    on_card = torch.device(device).type == 'cuda'
    for _ in range(warmup):
        fn()
    if on_card:
        torch.cuda.synchronize(device)
    times = []
    for _ in range(iters):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return {'mean': float(np.mean(times)), 'p50': float(np.percentile(times, 50)),
            'p90': float(np.percentile(times, 90))}


@contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block, host and (on the card) device
    activity, written to ``log_dir`` as a Chrome trace
    (``trace.json``, which chrome://tracing and Perfetto read). Yields
    ``log_dir``, as the JAX package's ``trace`` does."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, 'trace.json'))
