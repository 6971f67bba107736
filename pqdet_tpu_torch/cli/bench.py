"""Eval CLI (the port of ``pqdet_tpu/cli/bench.py``, its ``eval`` mode).

    python -m pqdet_tpu_torch.cli.bench eval --yaml exp.yaml [--weight m.ckpt] \
        [--int8-exact] [--device cuda|cpu] [key value ...]

``eval`` scores the eval split (``dataset.eval_txt_file``) and prints the
AP table, then ``AP <repr of the float>``. A 'quant' checkpoint runs through ``load_quantized`` and
``Int8Inference``: mode ``kernel`` (the int8 kernels and the decode kernel
on the card), or the exact integer mode ``int`` with ``--int8-exact``. Any
other checkpoint, or the config's model with no ``--weight``, runs the
BN-folded fp walk through the predict pipeline, through the fused-IR
kernel when ``eval.fused_ir`` is on. The JAX CLI's ``benchmark``,
``summary`` and ``time`` modes are not ported yet and raise.
"""

from __future__ import annotations

import argparse

from pqdet_tpu_torch.config import later

MODES = ('eval', 'benchmark', 'summary', 'time')


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
    from pqdet_tpu_torch.model.factory import build_detector, inference_params
    cfg_text = None if args.weight else resolve_model_cfg(cfg)
    network, params, state, _ = build_detector(cfg_text, weight_path=args.weight or None,
                                               device=args.device)
    fused = inference_params(network, params, state)
    table = None
    if cfg.eval.fused_ir:
        from pqdet_tpu_torch.ops.fused_ir import prepare_fused_ir
        table = prepare_fused_ir(network, fused)
        print(f'fused_ir: {len(table)} inverted-residual chains through the CUDA kernel')
    run = build_predict_pipeline(network, cfg, fused_ir=table, device=args.device)
    return make_batch_predict(run, fused)


def cmd_eval(args, cfg):
    from pqdet_tpu_torch.data.eval_data import EvalData
    from pqdet_tpu_torch.evaluation.evaluator import Evaluator, format_ap_table
    evaluator = Evaluator(make_predict(args, cfg), EvalData(cfg), cfg)
    ap = evaluator.evaluate()
    print(format_ap_table(ap, verbose=True))
    print(f'AP {ap.AP!r}')
    return ap


def main(argv=None):
    parser = argparse.ArgumentParser(description='eval CLI')
    parser.add_argument('mode', choices=MODES)
    parser.add_argument('--yaml', default=None)
    parser.add_argument('--weight', default='')
    parser.add_argument('--cfg', default='')
    parser.add_argument('--int8-exact', action='store_true',
                        help='evaluate quant checkpoints with exact integer accumulation '
                             'instead of the int8 kernels')
    parser.add_argument('--device', default='cuda')
    args, rest = parser.parse_known_args(argv)

    if args.mode != 'eval':
        raise later(f'bench {args.mode}', 'queue 1, item 10 (exporters and the '
                    'remaining CLIs)')
    from pqdet_tpu_torch.config import load_config
    cfg = load_config(args.yaml, rest)
    if args.cfg:
        cfg.model.cfg_path = args.cfg
    return cmd_eval(args, cfg)


if __name__ == '__main__':
    main()
