#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (pqdet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from pqdet_tpu_torch/csrc with nvcc (sm_90a), then:

1. prints the card (nvidia-smi name, power limit), torch and CUDA versions
   and the build time;
2. holds the Triton decode kernel to the plain decode on the card, at the
   three head shapes of mobilenetv2-fpn at 512x512 (B=4, bf16 and f32),
   an odd H and an exp_cap case (rtol = atol = 1e-5; for a box
   coordinate relative to its operands, see decode_tolerance);
3. holds the CUDA fused inverted-residual kernel to fused_ir_reference on
   the card, at all 21 chain shapes of mobilenetv2-fpn at 512x512, B=1 and
   B=4, plus raised biases for the zero-pad domain (tol 0.02*max(1,|r|),
   median below tol/4);
4. serves mobilenetv2-fpn (20 classes, 3 anchors, 512x512, random weights
   and BN statistics from a seed, BN folded, bf16, fused-IR table of 21
   chains) through build_predict_pipeline: 16 requests of 4 uint8
   images. The kernels' launch counts are set to 0 just before and read
   just after; each must be exactly 21 (fused IR) and 3 (decode) per
   forward. The kernel path's preds are compared with the plain fused
   path on the card (scores 0.03, boxes 1.5 px) and with the cuDNN layer
   walk (scores 0.03, boxes 3 px), and every detection must be finite;
5. times, with CUDA events after warm-up, requests at B=1 and B=4 and each
   stage of a B=4 request alone (normalize, forward, recover, NMS, copy to
   the host); and as device time (calls captured in a CUDA graph), each
   kernel per forward, its plain version, and for the fused chains three
   cuDNN convs with bias and activation as the library yardstick; a
   torch.profiler trace of B=4 requests gives the device's busy share and
   its top kernels.

It prints one JSON line of kernels, then the nvidia-smi line, and ends with
{"ok": true, "device": {...}}. Any failure exits non-zero before that line.
TF32 is off for cuDNN and matmul throughout, so f32 comparisons are f32.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
SEED = 0
N_REQUESTS = 16
BATCH = 4
SIZE = 512


def smi() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """ms per call of ``fn``, CUDA events around ``iters`` calls after
    ``warmup``: what a caller waits, host launch costs included."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=20, replays=5) -> float:
    """Device ms per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events, so no host
    launch cost is in it (a small kernel's launch takes longer than its
    run)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode='relaxed'):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def chain_shapes(net, size):
    """(a, b, c, H, Cin, E, P, acts) of each fused chain at input ``size``."""
    from pqdet_tpu_torch.ops.fused_ir import find_fused_triples
    nodes = {n.index: n for n in net.graph.nodes}
    out = []
    for a, b, c in find_fused_triples(net.graph):
        nb, nc = nodes[b], nodes[c]
        cin = nodes[a].in_channels if a is not None else nb.in_channels
        act_e = nodes[a].attrs['activation'] if a is not None else 'linear'
        out.append((a, b, c, size // nb.stride, cin, nb.in_channels,
                    nc.out_channels, (act_e, nb.attrs['activation'],
                                      nc.attrs['activation'])))
    return out


def chain_inputs(gen, n, h, cin, e, p, expand, dev, bias_shift=0.0):
    import torch

    def r(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    x = r(n, h, h, cin).to(dev, torch.bfloat16).contiguous()
    we = r(cin, e, scale=0.2).to(dev, torch.bfloat16) if expand else None
    be = (r(e, scale=0.1) + bias_shift).to(dev) if expand else None
    wdw = r(9, e, scale=0.2).to(dev, torch.bfloat16)
    bdw = (r(e, scale=0.1) + bias_shift).to(dev)
    wp = r(e, p, scale=0.2).to(dev, torch.bfloat16)
    bp = r(p, scale=0.1).to(dev)
    return x, we, be, wdw, bdw, wp, bp


def decode_tolerance(raw, nc, stride, exp_cap, rtol=1e-5, atol=1e-5):
    """Per-element tolerance of a (B, H, W, A, 5+C) decode of ``raw``:
    rtol/atol 1e-5 on the scores; a box (centre -/+ exp(d)) * stride
    cancels where exp(d) ~ centre, so there rtol is taken relative to the
    operands, stride * (centre + exp(d))."""
    import torch
    b, h, w, _ = raw.shape
    r = raw.float().reshape(b, h, w, -1, 5 + nc)
    d = r[..., :4].clamp(max=exp_cap) if exp_cap else r[..., :4]
    cy, cx = torch.meshgrid(torch.arange(h, device=raw.device) + 0.5,
                            torch.arange(w, device=raw.device) + 0.5, indexing='ij')
    centre = torch.stack([cx, cy, cx, cy], -1)[:, :, None, :]
    box = atol + rtol * stride * (centre + torch.exp(d))
    score = atol + rtol * torch.sigmoid(r[..., 4:]).abs()
    return torch.cat([box, score], -1)


def fused_bound_ms(n, h, cin, e, p, expand):
    pix = n * h * h
    flops = 2 * pix * ((cin * e if expand else 0) + 9 * e + e * p)
    nbytes = pix * (cin + p) * 2 + ((cin * e * 2 + e * 4) if expand else 0) \
        + 9 * e * 2 + e * 4 + e * p * 2 + p * 4
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOP_PER_S * 1e3


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script '
              'runs only on a GPU', file=sys.stderr)
        return 2
    import pqdet_tpu_torch  # noqa: F401  (fails outside a checkout)
    import torch.nn.functional as F
    from pqdet_tpu_torch.config import Config
    from pqdet_tpu_torch.evaluation.predict import (build_predict_pipeline,
                                                    make_batch_predict)
    from pqdet_tpu_torch.model.decode import decode
    from pqdet_tpu_torch.model.network import (DetectionNetwork, cast_params,
                                               fuse_params)
    from pqdet_tpu_torch.ops._build import build_all
    from pqdet_tpu_torch.ops.decode_kernel import decode_head
    from pqdet_tpu_torch.ops.fused_ir import (_apply_act, fused_ir_conv,
                                              fused_ir_reference,
                                              prepare_fused_ir)
    from pqdet_tpu_torch.ops.postprocess import nms_batch, recover_bboxes
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    from pqdet_tpu_torch.zoo import get_cfg

    dev = torch.device('cuda', 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smi()
    tag = f'[{card}]'

    # ---- phase 1: card, versions, build
    import triton
    print(f'phase 1: card {card}; torch {torch.__version__}, CUDA '
          f'{torch.version.cuda}, triton {triton.__version__}, python '
          f'{sys.version.split()[0]}')
    print('TF32 off: torch.backends.cudnn.allow_tf32 = False, '
          'torch.backends.cuda.matmul.allow_tf32 = False')
    t0 = time.perf_counter()
    report = build_all()
    print(f'phase 1: built {sorted(report)} in {time.perf_counter() - t0:.2f} s')
    for name, r in report.items():
        print(f'  nvcc {name}: {r["seconds"]:.2f} s -> {r["path"]}\n'
              + '\n'.join('    ' + ln for ln in r['log'].splitlines()))
    gen = torch.Generator().manual_seed(SEED)

    # ---- phase 2: decode kernel vs plain decode
    net = DetectionNetwork.from_cfg(get_cfg('mobilenetv2-fpn'))
    heads = [(SIZE // y.attrs['stride'], y.attrs['stride']) for y in net.graph.yolo_nodes]
    nc = net.num_classes
    cases = [(BATCH, h, h, s, dt, 0.0) for h, s in heads
             for dt in (torch.bfloat16, torch.float32)]
    cases += [(2, 13, 16, 8, torch.float32, 0.0), (BATCH, 16, 16, 32, torch.float32, 2.0)]
    decode_err = 0.0
    for b, h, w, s, dt, cap in cases:
        raw = (torch.randn(b, h, w, 3 * (5 + nc), generator=gen) * 2).to(dev, dt)
        got = decode_head(raw, nc, s, exp_cap=cap)
        ref = decode(raw, nc, s, exp_cap=cap)
        torch.cuda.synchronize()
        err = (got - ref).abs()
        ok = bool((err <= decode_tolerance(raw, nc, s, cap)).all())
        decode_err = max(decode_err, err.max().item())
        print(f'phase 2: decode B={b} H={h} W={w} stride={s} {dt} exp_cap={cap}: '
              f'max |err| {err.max().item():.3g} {"ok" if ok else "FAIL"}')
        if not ok:
            raise AssertionError('decode kernel disagrees with the plain decode')

    # ---- phase 3: fused IR kernel vs fused_ir_reference
    chains = chain_shapes(net, SIZE)
    if len(chains) != 21:
        raise AssertionError(f'expected 21 fused chains, found {len(chains)}')
    fused_err, failures = 0.0, []
    checks = [(ch, n, 0.0) for ch in chains for n in (1, BATCH)]
    checks += [(chains[0], 1, 3.0), (chains[-1], 1, 3.0)]   # pad domain
    for (a, b, c, h, cin, e, p, acts), n, shift in checks:
        args = chain_inputs(gen, n, h, cin, e, p, a is not None, dev, shift)
        kw = dict(act_e=acts[0], act_dw=acts[1], act_p=acts[2])
        got = fused_ir_conv(*args, **kw).float()
        ref = fused_ir_reference(*args, **kw).float()
        torch.cuda.synchronize()
        err = (got - ref).abs()
        tol = 0.02 * max(1.0, ref.abs().max().item())
        ok = bool(torch.isfinite(got).all()) and err.max().item() <= tol \
            and err.median().item() < tol / 4
        fused_err = max(fused_err, err.max().item())
        print(f'phase 3: fused chain {a},{b},{c} N={n} H=W={h} Cin={cin} E={e} '
              f'P={p} bias+{shift}: max |err| {err.max().item():.4g} median '
              f'{err.median().item():.3g} tol {tol:.3g} {"ok" if ok else "FAIL"}')
        if not ok:
            failures.append((a, b, c, n, shift))
    if failures:
        raise AssertionError(f'fused IR kernel disagrees on {failures}')

    # ---- phase 4: the main path
    cfg = Config()
    cfg.eval.input_size = SIZE
    cfg.eval.fused_ir = True
    params, state = net.init(gen, device=dev)
    # gain 2 on every conv weight: the init's fan-in bound shrinks each
    # layer's output by about 1/sqrt(3), which fades the activations over
    # the depth and leaves every score near 0.25; with the gain they keep
    # their scale, so the comparisons below see real differences. BN
    # statistics as a trained model has them: at init they fold into zero
    # biases, and the kernels' bias paths would go untested here
    for k, p in params.items():
        p['w'] = p['w'] * 2.0
        if 'bn' in p:
            c = p['w'].shape[0]
            u = lambda: (0.8 + 0.4 * torch.rand(c, generator=gen)).to(dev)  # noqa: E731
            p['bn'] = {'gamma': u(), 'beta': (0.1 * torch.randn(c, generator=gen)).to(dev)}
            state[k] = {'mean': (0.1 * torch.randn(c, generator=gen)).to(dev), 'var': u()}
    fused = fuse_params(net, params, state)
    table = prepare_fused_ir(net, fused)
    if len(table) != 21:
        raise AssertionError(f'fused-IR table has {len(table)} entries, not 21')
    fparams = cast_params(fused, torch.bfloat16)
    run = build_predict_pipeline(net, cfg, compute_dtype=torch.bfloat16,
                                 fused_ir=table, device=dev)
    predict = make_batch_predict(run, fparams)
    rng = torch.Generator().manual_seed(SEED + 1)

    def batch(b):
        img = torch.randint(0, 256, (b, SIZE, SIZE, 3), generator=rng, dtype=torch.uint8)
        hw = torch.randint(200, 900, (b, 2), generator=rng)
        return {'image': img.to(dev), 'shape': hw.to(dev), 'count': b}

    requests = [batch(BATCH) for _ in range(N_REQUESTS)]
    predict(requests[0])                      # warm-up: Triton compile
    torch.cuda.synchronize()
    fused_ir_conv.launches = 0
    decode_head.launches = 0
    dets = [predict(r) for r in requests]
    torch.cuda.synchronize()
    launches = {'fused_ir': fused_ir_conv.launches, 'decode': decode_head.launches}
    want = {'fused_ir': 21 * N_REQUESTS, 'decode': 3 * N_REQUESTS}
    print(f'phase 4: served {N_REQUESTS} requests of {BATCH} images at {SIZE}x{SIZE}; '
          f'launches {launches} (want {want})')
    if launches != want:
        raise AssertionError(f'kernel launches {launches} != {want}')
    n_det = sum(len(d) for r in dets for d in r)
    for r in dets:
        for d in r:
            if d.shape[1] != 6 or not bool(torch.isfinite(torch.from_numpy(d)).all()):
                raise AssertionError('a detection is not finite or has the wrong shape')
            if len(d) and not ((d[:, 5] >= 0) & (d[:, 5] < nc)).all():
                raise AssertionError('a detection has a class outside the model')
    print(f'phase 4: {n_det} detections, all finite')

    with torch.inference_mode():
        x = device_normalize(requests[0]['image'])
        kern = net(fparams, {}, x, compute_dtype=torch.bfloat16, fused_ir=table)
        plain = net(fparams, {}, x, compute_dtype=torch.bfloat16, fused_ir=table, plain=True)
        walk = net(fparams, {}, x, compute_dtype=torch.bfloat16, plain=True)
    rows = sum((SIZE // s) ** 2 * 3 for _, s in heads)
    if tuple(kern.shape) != (BATCH, rows, 5 + nc) or not bool(torch.isfinite(kern).all()):
        raise AssertionError(f'preds {tuple(kern.shape)} not finite (B, {rows}, {5 + nc})')
    # the plain fused path rounds where the kernel does: the bounds of the
    # JAX package's fused-walk test (scores 0.03, boxes 1.5 px). The layer
    # walk (cuDNN convs) rounds each conv's sum to bf16 before its bias add,
    # the kernel after it; at 512 px with nonzero biases that alone moves
    # boxes by over 1 px, so its box bound is 3 px (a wrong bias,
    # activation or pad moves scores by far more than 0.03)
    for name, ref, box_tol in (('plain fused path', plain, 1.5),
                               ('plain layer walk', walk, 3.0)):
        ds = (kern[..., 4:] - ref[..., 4:]).abs().max().item()
        db = (kern[..., :4] - ref[..., :4]).abs().max().item()
        print(f'phase 4: kernel path vs {name}: scores max |d| {ds:.4g} (<= 0.03), '
              f'boxes max |d| {db:.4g} (<= {box_tol})')
        if not (ds <= 0.03 and db <= box_tol):
            raise AssertionError(f'kernel path disagrees with the {name}')

    # ---- phase 5: timings (CUDA events, after warm-up; kernels, their plain
    # versions and cuDNN as device time, from CUDA graphs)
    for b in (1, BATCH):
        reqs = [batch(b) for _ in range(5)]
        for r in reqs[:2]:
            predict(r)
        times = []
        for i in range(20):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            predict(reqs[i % len(reqs)])
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        times.sort()
        p50, p90 = statistics.median(times), times[int(0.9 * (len(times) - 1))]
        print(f'phase 5: {tag} request B={b}: p50 {p50:.3f} ms, p90 {p90:.3f} ms, '
              f'{b * 1000.0 / p50:.1f} images/s')

    # where a B=4 request's time goes: each stage alone, and a profiler trace
    rb = batch(BATCH)
    ev = cfg.eval
    with torch.inference_mode():
        xb = device_normalize(rb['image'])
        preds = net(fparams, {}, xb, compute_dtype=torch.bfloat16, fused_ir=table)
        in_size = torch.tensor([SIZE, SIZE], dtype=torch.float32, device=dev)
        hw = rb['shape'].float()
        rec = recover_bboxes(preds, in_size, hw)
        res = nms_batch(rec, ev.score_threshold, ev.iou_threshold, ev.max_detections,
                        ev.pool_factor, ev.nms_method, ev.nms_sigma)
        stages = {
            'normalize': lambda: device_normalize(rb['image']),
            'forward': lambda: net(fparams, {}, xb, compute_dtype=torch.bfloat16,
                                   fused_ir=table),
            'recover': lambda: recover_bboxes(preds, in_size, hw),
            'nms': lambda: nms_batch(rec, ev.score_threshold, ev.iou_threshold,
                                     ev.max_detections, ev.pool_factor,
                                     ev.nms_method, ev.nms_sigma),
            'to_host': lambda: [t.cpu().numpy() for t in res],
        }
        split = {name: cuda_ms(fn, iters=10) for name, fn in stages.items()}
        fwd_device = device_ms(stages['forward'], iters=3, replays=3)
    print(f'phase 5: {tag} B={BATCH} request by stage, each alone: '
          + ', '.join(f'{k} {v:.3f} ms' for k, v in split.items())
          + f'; forward on the device alone (CUDA graph) {fwd_device:.3f} ms')
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    r = batch(BATCH)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            predict(r)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 3
    kern_ev = [ev for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA]
    busy_ms = sum(ev.self_device_time_total for ev in kern_ev) / 1e3 / 3
    if busy_ms > 0:
        print(f'phase 5: {tag} profiled B={BATCH} request: wall {wall_ms:.3f} ms, '
              f'device busy {busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f}')
        for ev in sorted(kern_ev, key=lambda e: -e.self_device_time_total)[:8]:
            print(f'  {ev.self_device_time_total / 1e3 / 3:9.4f} ms/request '
                  f'{ev.count // 3:4d} launches  {ev.key[:90]}')
    else:
        print(f'phase 5: {tag} profiler saw no device time: busy share not measured')

    # decode: the three heads of one B=4 bf16 forward
    dec = {'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0}
    for h, s in heads:
        raw = torch.randn(BATCH, h, h, 3 * (5 + nc), generator=gen).to(dev, torch.bfloat16)
        k_ms = device_ms(lambda: decode_head(raw, nc, s))
        call_ms = cuda_ms(lambda: decode_head(raw, nc, s))
        p_ms = device_ms(lambda: decode(raw, nc, s))
        nbytes = raw.numel() * (2 + 4)
        dec['ms'] += k_ms
        dec['plain_ms'] += p_ms
        dec['bound_ms'] += nbytes / HBM_BYTES_PER_S * 1e3
        print(f'phase 5: {tag} decode B={BATCH} H=W={h}: kernel {k_ms:.4f} ms '
              f'({call_ms:.4f} ms a call with its launch), plain {p_ms:.4f} ms, '
              f'bound {nbytes / HBM_BYTES_PER_S * 1e3:.5f} ms (bytes)')

    # fused IR: each chain at B=4, its plain version and three cuDNN convs
    fir = dict.fromkeys(('ms', 'plain_ms', 'bound_ms', 'library_ms', 'call_ms',
                         'library_call_ms'), 0.0)
    byte_ms_sum = flop_ms_sum = 0.0
    for a, b, c, h, cin, e, p, acts in chains:
        expand = a is not None
        args = chain_inputs(gen, BATCH, h, cin, e, p, expand, dev)
        x, we, be, wdw, bdw, wp, bp = args
        kw = dict(act_e=acts[0], act_dw=acts[1], act_p=acts[2])
        w_e = we.t().reshape(e, cin, 1, 1).contiguous() if expand else None
        w_dw = wdw.t().reshape(e, 1, 3, 3).contiguous()
        w_p = wp.t().reshape(p, e, 1, 1).contiguous()
        b16 = lambda t: t.to(torch.bfloat16)  # noqa: E731
        xc = x.permute(0, 3, 1, 2)                         # channels_last view

        def cudnn_chain():
            y = xc
            if expand:
                y = _apply_act(acts[0], F.conv2d(y, w_e, b16(be)))
            y = _apply_act(acts[1], F.conv2d(y, w_dw, b16(bdw), 1, 1, 1, e))
            return _apply_act(acts[2], F.conv2d(y, w_p, b16(bp)))

        k_ms = device_ms(lambda: fused_ir_conv(*args, **kw))
        call_ms = cuda_ms(lambda: fused_ir_conv(*args, **kw))
        p_ms = device_ms(lambda: fused_ir_reference(*args, **kw))
        l_ms = device_ms(cudnn_chain)
        l_call_ms = cuda_ms(cudnn_chain)
        by_ms, fl_ms = fused_bound_ms(BATCH, h, cin, e, p, expand)
        fir['ms'] += k_ms
        fir['plain_ms'] += p_ms
        fir['library_ms'] += l_ms
        fir['call_ms'] += call_ms
        fir['library_call_ms'] += l_call_ms
        fir['bound_ms'] += max(by_ms, fl_ms)
        byte_ms_sum += by_ms
        flop_ms_sum += fl_ms
        print(f'phase 5: {tag} fused chain {a},{b},{c} B={BATCH} H=W={h} Cin={cin} '
              f'E={e} P={p}: kernel {k_ms:.4f} ms ({call_ms:.4f} ms a call with its '
              f'launch), plain {p_ms:.4f} ms, cuDNN x3 {l_ms:.4f} ms ({l_call_ms:.4f} '
              f'ms a call with its launches), bound {max(by_ms, fl_ms):.5f} ms '
              f'({"operations" if fl_ms > by_ms else "bytes"})')
    print(f'phase 5: {tag} fused IR per B={BATCH} forward (21 launches): kernel '
          f'{fir["ms"]:.4f} ms, plain {fir["plain_ms"]:.4f} ms, cuDNN x3 '
          f'{fir["library_ms"]:.4f} ms, bound {fir["bound_ms"]:.5f} ms; calls with '
          f'their launches: kernel {fir["call_ms"]:.4f} ms, cuDNN x3 '
          f'{fir["library_call_ms"]:.4f} ms')
    print(f'phase 5: {tag} decode per B={BATCH} forward (3 launches): kernel '
          f'{dec["ms"]:.4f} ms, plain {dec["plain_ms"]:.4f} ms, bound '
          f'{dec["bound_ms"]:.5f} ms')

    kernels = [
        {'name': 'decode_head', 'route': 'triton',
         'source': 'pqdet_tpu_torch/ops/decode_kernel.py',
         'replaces': 'pqdet_tpu/ops/pallas_decode.py:59',
         'launches': launches['decode'], 'max_abs_err': decode_err,
         'ms': dec['ms'], 'plain_ms': dec['plain_ms'], 'bound_ms': dec['bound_ms'],
         'bound_by': 'bytes', 'library_ms': None},
        {'name': 'fused_ir_conv', 'route': 'cuda',
         'source': 'pqdet_tpu_torch/csrc/fused_ir.cu',
         'replaces': 'pqdet_tpu/ops/pallas_fused.py:135',
         'launches': launches['fused_ir'], 'max_abs_err': fused_err,
         'ms': fir['ms'], 'plain_ms': fir['plain_ms'], 'bound_ms': fir['bound_ms'],
         'bound_by': 'operations' if flop_ms_sum > byte_ms_sum else 'bytes',
         'library_ms': fir['library_ms']},
    ]
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
