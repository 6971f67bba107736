#!/usr/bin/env python3
"""Sweep the launch plans of the port's three CUDA kernels on one NVIDIA GPU.

    python3 plan_sweep.py [fused|qconv|dw|all] [zoo model ...]

- fused: each of the 21 fused-IR chains of mobilenetv2-fpn at 512x512, B=4,
  under the plans ``plan_fused_ir`` makes with the cluster capped at 2, 4
  and 8 ranks (its MAX_CLUSTER), device ms from CUDA graphs;
- qconv: each pointwise shape of the int8 graph at 512x512, B=4 (of
  mobilenetv2-fpn, or of the zoo models named after the mode: the
  RegNets' densified grouped 3x3s as their im2col shapes, K up to 4752),
  under every plan the qconv1x1 kernel takes (bm, bn, bk, split, stages),
  each checked bit for bit against the plain version, device ms from CUDA
  graphs; prints the current plan's time and the best three;
- dw: each depthwise shape of the int8 graph at 512x512, B=4, under every
  tile (th, tw, cs) the depthwise kernel takes with up to 16 units a
  thread, each checked bit for bit against the plain version, device ms
  from CUDA graphs; prints the current plan's time, the best three and
  the bytes bound.

The plans' rules (ops/fused_ir.py, ops/qconv.py) were read off these
sweeps; PERF.md keeps the numbers. Needs a card; prints the card's name and
power limit first.
"""

from __future__ import annotations

import itertools
import os
import sys


def sweep_fused(dev, gen):
    import chip_smoke as cs
    from pqdet_tpu_torch.model.network import DetectionNetwork
    from pqdet_tpu_torch.ops import fused_ir as fir
    from pqdet_tpu_torch.zoo import get_cfg
    net = DetectionNetwork.from_cfg(get_cfg('mobilenetv2-fpn'))
    caps = (2, 4, 8)
    total = dict.fromkeys(caps, 0.0)
    keep = fir.MAX_CLUSTER
    try:
        for a, b, c, h, cin, e, p, acts in cs.chain_shapes(net, 512):
            args = cs.chain_inputs(gen, 4, h, cin, e, p, a is not None, dev)
            kw = dict(act_e=acts[0], act_dw=acts[1], act_p=acts[2])
            line = []
            for cap in caps:
                fir.MAX_CLUSTER = cap
                fir.plan_fused_ir.cache_clear()
                pl = fir.plan_fused_ir(4, h, h, cin, e, p, a is not None)
                ms = cs.device_ms(lambda: fir.fused_ir_conv(*args, **kw))
                total[cap] += ms
                line.append(f'cap {cap}: {ms:.4f} ms (tile {pl.th}x{pl.tw} cluster '
                            f'{pl.cluster} reduce {pl.reduce} ck {pl.ck} stages {pl.stages})')
            print(f'fused {a},{b},{c} {h}x{h} {cin}/{e}/{p}: ' + '; '.join(line))
    finally:
        fir.MAX_CLUSTER = keep
        fir.plan_fused_ir.cache_clear()
    print('fused per B=4 forward: ' + ', '.join(f'cap {k}: {v:.4f} ms' for k, v in total.items()))


def sweep_qconv(dev, gen, models=('mobilenetv2-fpn',)):
    import torch

    import chip_smoke as cs
    from pqdet_tpu_torch.model.network import DetectionNetwork
    from pqdet_tpu_torch.ops import qconv as qc
    from pqdet_tpu_torch.zoo import get_cfg
    lib = qc._library()
    shapes = {}
    for name in models:
        net = DetectionNetwork.from_cfg(get_cfg(name), quant=True)
        for (kind, h, _, k, n, _, _, rq), count in cs.int8_conv_shapes(net, 512).items():
            if kind != 'dw':
                shapes[(h, k, n, rq)] = shapes.get((h, k, n, rq), 0) + count
    cur_total = best_total = 0.0
    for (h, k, n, rq), count in sorted(shapes.items()):
        m = 4 * h * h
        x, wq, ws, b, cs_, x_scale, x_zp = cs.int8_inputs(gen, 'pw', 4, h, h, k, n, dev)
        sc = qc.make_scalars(x_scale, x_zp, 0.05 if rq else None, 3.0 if rq else None, dev)
        out = torch.empty(4, h, h, n, dtype=torch.int8 if rq else torch.float32, device=dev)
        ref = qc.qconv1x1_reference(x, wq, ws, b, cs_, act='relu', scalars=sc, requant=rq)
        results = []
        for bm, bk in itertools.product((64, 128), (32, 64, 128)):
            ksteps = -(-k // bk)
            if bk > 32 and bk >= 2 * max(32, k):
                continue
            for bn, split, stages in itertools.product((32, 64, 128), range(1, 9), (2, 3)):
                kpr = -(-ksteps // split)
                if (bn // (8 // (bm // 32))) % 16 or bn // (8 // (bm // 32)) > 32 \
                        or split > ksteps or -(-ksteps // kpr) != split:
                    continue
                smem = qc.qconv1x1_smem_bytes(bm, bn, bk, stages)
                plan = (bm, bn, bk, split, kpr, stages, smem)

                def run():
                    rc = lib.qconv1x1_launch(
                        x.data_ptr(), wq.data_ptr(), ws.data_ptr(), b.data_ptr(),
                        cs_.data_ptr(), sc.data_ptr(), out.data_ptr(), m, k, n, 1, int(rq),
                        *plan, torch.cuda.current_stream().cuda_stream)
                    if rc != 0:
                        raise RuntimeError(f'qconv1x1 launch failed with CUDA error {rc}')
                run()
                torch.cuda.synchronize()
                if not torch.equal(out, ref):
                    raise AssertionError(f'qconv1x1 plan {plan} disagrees with its plain version')
                results.append((cs.device_ms(run, iters=10, replays=3), plan))
        results.sort()
        cur = qc.plan_qconv1x1(m, k, n).c_args
        cur_ms = next((ms for ms, pl in results if pl == cur), float('nan'))
        cur_total += count * cur_ms
        best_total += count * results[0][0]
        print(f'qconv {h}x{h} {k}->{n} x{count}: current {cur_ms:.4f} ms {cur[:6]}; best '
              + '; '.join(f'{ms:.4f} ms {pl[:6]}' for ms, pl in results[:3]))
    print(f'qconv per B=4 forward of {" + ".join(models)}: current plans {cur_total:.4f} ms, '
          f'best plans {best_total:.4f} ms')


def sweep_dw(dev, gen):
    import torch

    import chip_smoke as cs
    from pqdet_tpu_torch.model.network import DetectionNetwork
    from pqdet_tpu_torch.ops import qconv as qc
    from pqdet_tpu_torch.zoo import get_cfg
    lib = qc._library()
    net = DetectionNetwork.from_cfg(get_cfg('mobilenetv2-fpn'), quant=True)
    cur_total = best_total = bound_total = 0.0
    for (kind, h, _, c, _, s, act, rq), count in sorted(cs.int8_conv_shapes(net, 512).items()):
        if kind != 'dw':
            continue
        x, wq, ws, b, _, x_scale, x_zp = cs.int8_inputs(gen, 'dw', 4, h, h, c, c, dev)
        sc = qc.make_scalars(x_scale, x_zp, 0.05, 3.0, dev)
        ho = h // s
        out = torch.empty(4, ho, ho, c, dtype=torch.int8, device=dev)
        ref = qc.qdwconv3x3_reference(x, wq, ws, b, act=act, stride=s, scalars=sc,
                                      requant=True)
        cur = qc.plan_qdwconv3x3(4, h, h, c, s).c_args
        results = []
        for th, tw, csl in itertools.product((1, 2, 4, 8, 16, 32), (4, 8, 16, 32),
                                             (16, 32, 64, 128)):
            if th > max(1, ho) * 2 or tw > max(4, ho) * 2 or csl > c \
                    or (csl // 4) * th * (tw // 4) > 16 * 256:
                continue
            smem = qc.qdwconv3x3_smem_bytes(th, tw, csl, s)
            if smem > qc.SMEM_TWO:               # fewer than two CTAs an SM
                continue
            plan = (th, tw, csl, cur[3], smem, 4 * -(-ho // th) * -(-ho // tw) * -(-c // csl))

            def run():
                rc = lib.qdw3x3_launch(
                    x.data_ptr(), wq.data_ptr(), ws.data_ptr(), b.data_ptr(), sc.data_ptr(),
                    out.data_ptr(), 4, h, h, c, s, qc.ACT_CODES[act], 1, *plan,
                    torch.cuda.current_stream().cuda_stream)
                if rc != 0:
                    raise RuntimeError(f'qdw3x3 plan {plan} launch failed with CUDA error {rc}')
            out.fill_(0)
            run()
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f'qdw3x3 plan {plan} disagrees with its plain version')
            results.append((cs.device_ms(run, iters=10, replays=3), plan))
        results.sort()
        cur_ms = next((ms for ms, pl in results if pl == cur), float('nan'))
        bound = cs.int8_bound_ms('dw', 4, h, h, c, c, s, True)[0]
        cur_total += count * cur_ms
        best_total += count * results[0][0]
        bound_total += count * bound
        print(f'dw {h}x{h} C={c} s={s} x{count}: bound {bound:.5f} ms; current {cur_ms:.4f} '
              f'ms {cur[:3]}; best ' + '; '.join(f'{ms:.4f} ms {pl[:3]}' for ms, pl in results[:3]))
    print(f'dw per B=4 forward: current plans {cur_total:.4f} ms, best plans '
          f'{best_total:.4f} ms, bound {bound_total:.5f} ms')


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch
    if not torch.cuda.is_available():
        print('plan_sweep: no GPU', file=sys.stderr)
        return 2
    import chip_smoke as cs
    from pqdet_tpu_torch.ops._build import build_all
    which = sys.argv[1] if len(sys.argv) > 1 else 'all'
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi())
    build_all()
    dev = torch.device('cuda', 0)
    gen = torch.Generator().manual_seed(cs.SEED)
    if which in ('fused', 'all'):
        sweep_fused(dev, gen)
    if which in ('qconv', 'all'):
        sweep_qconv(dev, gen, tuple(sys.argv[2:]) or ('mobilenetv2-fpn',))
    if which in ('dw', 'all'):
        sweep_dw(dev, gen)
    return 0


if __name__ == '__main__':
    sys.exit(main())
