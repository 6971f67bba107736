"""Eval, benchmark, summary and time CLI (the port of ``pqdet_tpu/cli/bench.py``).

    python -m pqdet_tpu_torch.cli.bench eval --yaml exp.yaml [--weight m.ckpt] \
        [--int8-exact] [--device cuda|cpu] [key value ...]
    python -m pqdet_tpu_torch.cli.bench benchmark --yaml exp.yaml --weight m.ckpt \
        [--limit 100]
    python -m pqdet_tpu_torch.cli.bench summary [--cfg zoo-name|file.cfg] [--size 512]
    python -m pqdet_tpu_torch.cli.bench time [--cfg ...|--weight ...] [--bs 1] \
        [--size 512] [--bf16] [--trace DIR]

``eval`` scores the eval split (``dataset.eval_txt_file``) and prints the
AP table, then ``AP <repr of the float>``. A 'quant' checkpoint runs through ``load_quantized`` and
``Int8Inference``: mode ``kernel`` (the int8 kernels and the decode kernel
on the card), or the exact integer mode ``int`` with ``--int8-exact``. Any
other checkpoint, or the config's model with no ``--weight``, runs the
BN-folded fp walk through the predict pipeline, through the fused-IR
kernel when ``eval.fused_ir`` is on.

``summary`` prints the model's MACs and params at ``--size`` (thop's
convention, ``utils/profiling.py``). ``time`` times the BN-folded forward
of ``--weight`` (or the config's model, seeded) on a zero batch of
``--bs`` x ``--size``², in f32 or, with ``--bf16``, in bf16 through the
fused-IR kernel: CUDA events around each call after warm-up on the card,
the host clock on the CPU; ``--trace DIR`` writes a ``torch.profiler``
trace of 8 calls. ``benchmark`` times the four stages of a request over
the eval images (total, the f32 forward, convert = box recovery, NMS), each stage
ending in a ``torch.cuda.synchronize`` on the card. ``time --shlo`` (an
exported StableHLO artifact) waits for the exporters.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from pqdet_tpu_torch.config import later

MODES = ('eval', 'benchmark', 'summary', 'time')


def folded(network, params, state, fused_ir, dtype=None):
    """(BN-folded params, fused-IR table or None): the inference params of
    the model, in ``dtype``, and with ``fused_ir`` the chains' table for the
    fused-IR kernel."""
    from pqdet_tpu_torch.model.factory import inference_params
    fused = inference_params(network, params, state, dtype=dtype)
    if not fused_ir:
        return fused, None
    from pqdet_tpu_torch.ops.fused_ir import prepare_fused_ir
    return fused, prepare_fused_ir(network, fused)


def fp_predict(network, params, state, cfg, device):
    """The evaluator's predict function for an fp model: the BN-folded walk
    through the predict pipeline, through the fused-IR kernel when
    ``eval.fused_ir`` is on."""
    from pqdet_tpu_torch.evaluation.predict import build_predict_pipeline, make_batch_predict
    fused, table = folded(network, params, state, cfg.eval.fused_ir)
    if table is not None:
        print(f'fused_ir: {len(table)} inverted-residual chains through the CUDA kernel')
    run = build_predict_pipeline(network, cfg, fused_ir=table, device=device)
    return make_batch_predict(run, fused)


def make_predict(args, cfg):
    """The evaluator's predict function for ``args.weight`` (module
    docstring) on ``args.device``."""
    from pqdet_tpu_torch.evaluation.predict import build_predict_pipeline, make_batch_predict
    from pqdet_tpu_torch.utils.codec import load_checkpoint

    if args.weight and load_checkpoint(args.weight).get('type') == 'quant':
        from pqdet_tpu_torch.compress.quantized import Int8Inference, load_quantized
        mode = 'int' if args.int8_exact else 'kernel'
        network, qparams = load_quantized(args.weight, device=args.device)
        int8 = Int8Inference(network, mode=mode)
        run = build_predict_pipeline(network, cfg, apply_fn=int8.apply, device=args.device)
        return make_batch_predict(run, Int8Inference.prepare(qparams, mode=mode))

    from pqdet_tpu_torch.config import resolve_model_cfg
    from pqdet_tpu_torch.model.factory import build_detector
    cfg_text = None if args.weight else resolve_model_cfg(cfg)
    network, params, state, _ = build_detector(cfg_text, weight_path=args.weight or None,
                                               device=args.device)
    return fp_predict(network, params, state, cfg, args.device)


def cmd_eval(args, cfg):
    from pqdet_tpu_torch.data.eval_data import EvalData
    from pqdet_tpu_torch.evaluation.evaluator import Evaluator, format_ap_table
    evaluator = Evaluator(make_predict(args, cfg), EvalData(cfg), cfg)
    ap = evaluator.evaluate()
    print(format_ap_table(ap, verbose=True))
    print(f'AP {ap.AP!r}')
    return ap


def cmd_summary(args, cfg):
    from pqdet_tpu_torch.config import resolve_model_cfg
    from pqdet_tpu_torch.model.graph import Graph
    from pqdet_tpu_torch.utils.profiling import clever_format, count_macs_params
    macs, params = count_macs_params(Graph.from_cfg(resolve_model_cfg(cfg)),
                                     (args.size, args.size))
    print(f'flops:{clever_format(macs)}, params: {clever_format(params)}')
    return macs, params


def build_forward(cfg, weight, device, bf16=False):
    """forward(x) -> preds of the BN-folded model of ``weight`` (or the
    config's model, seeded), in f32 or, with ``bf16``, in bf16 through the
    fused-IR kernel; the decode kernel decodes the heads."""
    from pqdet_tpu_torch.config import resolve_model_cfg
    from pqdet_tpu_torch.model.factory import build_detector
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    cfg_text = None if weight else resolve_model_cfg(cfg)
    network, params, state, _ = build_detector(cfg_text, weight_path=weight or None,
                                               device=device)
    dtype = torch.bfloat16 if bf16 else None
    fused, table = folded(network, params, state, bf16, dtype)

    @torch.inference_mode()
    def forward(x):
        return network(fused, {}, device_normalize(x), compute_dtype=dtype, fused_ir=table)

    return forward


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def cmd_time(args, cfg):
    if args.shlo:
        raise later('bench time --shlo', 'queue 1, item 10 (exporters and the '
                    'remaining CLIs)')
    from pqdet_tpu_torch.utils.profiling import forward_latency_ms, trace
    forward = build_forward(cfg, args.weight, args.device, args.bf16)
    x = torch.zeros((args.bs, args.size, args.size, 3), dtype=torch.float32,
                    device=args.device)
    on_card = torch.device(args.device).type == 'cuda'
    t = forward_latency_ms(lambda: forward(x), args.device, *((10, 64) if on_card else (2, 8)))
    if args.trace:
        with trace(args.trace):
            for _ in range(8):
                forward(x)
        print(f'profiler trace written to {args.trace}')
    print(f'{t["mean"]:.3f}ms (p50 {t["p50"]:.3f}ms, p90 {t["p90"]:.3f}ms) bs={args.bs} '
          f'size={args.size} {"bf16" if args.bf16 else "f32"}  '
          f'[{"CUDA events around each call" if on_card else "host clock"}]')
    return t


def cmd_benchmark(args, cfg):
    """Per-stage timing over the eval images: total, the f32 forward (as
    the JAX package's mode, whatever ``--bf16`` says), convert (box
    recovery) and NMS, each stage waited for on the card."""
    from pqdet_tpu_torch.config import size_fix
    from pqdet_tpu_torch.data.eval_data import EvalData
    from pqdet_tpu_torch.evaluation.predict import RECOVER_AFFINE_REGISTER
    from pqdet_tpu_torch.ops.postprocess import nms_batch, recover_bboxes

    dev = torch.device(args.device)
    forward = build_forward(cfg, args.weight, dev)
    affine = RECOVER_AFFINE_REGISTER[cfg.dataset.name.lower()]
    input_size = torch.tensor(size_fix(cfg.eval.input_size), dtype=torch.float32, device=dev)
    ev = cfg.eval

    @torch.inference_mode()
    def convert(preds, shapes):
        return recover_bboxes(preds, input_size, shapes, affine=affine)

    @torch.inference_mode()
    def nms(rec):
        return nms_batch(rec, ev.score_threshold, ev.iou_threshold, ev.max_detections,
                         ev.pool_factor, ev.nms_method, ev.nms_sigma)

    times = {'total': [], 'forward': [], 'convert': [], 'nms': []}
    n_img = 0
    for i, batch in enumerate(EvalData(cfg).batches(cfg.system.num_workers)):
        x = torch.as_tensor(batch['image']).to(dev)
        shapes = torch.as_tensor(batch['shape']).to(dev, torch.float32)
        if i == 0:      # warm-up: first launches, kernel builds
            nms(convert(forward(x), shapes))
            _sync(dev)
        t0 = time.perf_counter()
        preds = forward(x)
        _sync(dev)
        t1 = time.perf_counter()
        rec = convert(preds, shapes)
        _sync(dev)
        t2 = time.perf_counter()
        nms(rec)
        _sync(dev)
        t3 = time.perf_counter()
        for name, dt in (('total', t3 - t0), ('forward', t1 - t0), ('convert', t2 - t1),
                         ('nms', t3 - t2)):
            times[name].append(dt * 1e3)
        n_img += batch['count']
        if args.limit and n_img >= args.limit:
            break
    stats = {}
    for name, ts in times.items():
        stats[name] = float(np.mean(ts))
        print('{}: mean {:.2f}ms/batch ({:.2f}ms/img over {} imgs)'.format(
            name, stats[name], stats[name] / max(ev.batch_size, 1), n_img))
    print('[host clock around each stage, each ended by torch.cuda.synchronize on the card]')
    return stats


def main(argv=None):
    parser = argparse.ArgumentParser(description='eval/benchmark CLI')
    parser.add_argument('mode', choices=MODES)
    parser.add_argument('--yaml', default=None)
    parser.add_argument('--weight', default='')
    parser.add_argument('--cfg', default='')
    parser.add_argument('--size', type=int, default=512)
    parser.add_argument('--bs', type=int, default=1)
    parser.add_argument('--bf16', action='store_true')
    parser.add_argument('--limit', type=int, default=100)
    parser.add_argument('--trace', default='',
                        help='write a torch.profiler trace to this directory')
    parser.add_argument('--shlo', default='',
                        help='time an exported StableHLO artifact (not ported yet)')
    parser.add_argument('--int8-exact', action='store_true',
                        help='evaluate quant checkpoints with exact integer accumulation '
                             'instead of the int8 kernels')
    parser.add_argument('--device', default='cuda')
    args, rest = parser.parse_known_args(argv)

    from pqdet_tpu_torch.config import load_config
    cfg = load_config(args.yaml, rest)
    if args.cfg:
        cfg.model.cfg_path = args.cfg
    return {'eval': cmd_eval, 'benchmark': cmd_benchmark,
            'summary': cmd_summary, 'time': cmd_time}[args.mode](args, cfg)


if __name__ == '__main__':
    main()
