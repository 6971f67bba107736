"""Prune CLI: slimming-prune a checkpoint, evaluate it, fine-tune it (the
port of ``pqdet_tpu/cli/prune.py``).

    python -m pqdet_tpu_torch.cli.prune --yaml exp.yaml [--device cuda|cpu] \
        [--skip-test] [--skip-finetune] \
        prune.weight model.ckpt prune.new_cfg pruned.cfg prune.ratio 0.3

Loads ``prune.weight``, prunes it at ``prune.ratio``
(``compress/prune.py``), prints the report, writes the pruned cfg to
``prune.new_cfg`` and the pruned weights to ``<weight>-pruned.ckpt``
beside the input (the JAX package's checkpoint format, the pruned cfg
embedded), and prints the MACs and params at 512² before and after. Unless
``--skip-test``, it scores the BN-folded pruned model on the eval split
(through the fused-IR kernel when ``eval.fused_ir`` is on, the decode
kernel always); unless ``--skip-finetune``, it fine-tunes it
(``Trainer.run_prune``).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from pqdet_tpu_torch.utils.debug import register_stack_dump
    register_stack_dump()
    parser = argparse.ArgumentParser(description='channel pruning')
    parser.add_argument('--yaml', default=None)
    parser.add_argument('--skip-test', action='store_true')
    parser.add_argument('--skip-finetune', action='store_true')
    parser.add_argument('--device', default='cuda')
    args, rest = parser.parse_known_args(argv)

    from pqdet_tpu_torch.compress.prune import prune_slimming
    from pqdet_tpu_torch.config import load_config, platform_device
    from pqdet_tpu_torch.model.factory import build_detector
    from pqdet_tpu_torch.model.graph import Graph
    from pqdet_tpu_torch.train.checkpoint import save_checkpoint
    from pqdet_tpu_torch.utils.profiling import clever_format, count_macs_params

    cfg = load_config(args.yaml, rest)
    args.device = platform_device(cfg, args.device)
    network, params, state, _ = build_detector(None, weight_path=cfg.prune.weight,
                                               device=args.device)
    print(f'load weights from {cfg.prune.weight}')

    result = prune_slimming(network.graph, params, state, cfg.prune.ratio)
    print('\n'.join(result.report))

    with open(cfg.prune.new_cfg, 'w') as fw:
        fw.write(result.cfg_text)
    pruned_graph = Graph.from_cfg(result.cfg_text)
    pruned_weight = cfg.prune.weight.rsplit('.', 1)[0] + '-pruned.ckpt'
    save_checkpoint(pruned_weight, pruned_graph, result.params, result.state, step=0,
                    cfg_text=result.cfg_text)
    print('Slimming Pruner done')

    size = (512, 512)
    macs0, params0 = count_macs_params(network.graph, size)
    macs1, params1 = count_macs_params(pruned_graph, size)
    print(f'flops: {clever_format(macs0)} -> {clever_format(macs1)}, '
          f'params: {clever_format(params0)} -> {clever_format(params1)}')

    if not args.skip_test:
        _test(cfg, result, args.device)
    if not args.skip_finetune:
        from pqdet_tpu_torch.train.trainer import Trainer
        Trainer(cfg, device=args.device).run_prune(pruned_weight)
    return result


def _test(cfg, result, device):
    from pqdet_tpu_torch.cli.bench import fp_predict
    from pqdet_tpu_torch.data.eval_data import EvalData
    from pqdet_tpu_torch.evaluation.evaluator import Evaluator, format_ap_table
    from pqdet_tpu_torch.model.network import DetectionNetwork

    network = DetectionNetwork.from_cfg(result.cfg_text)
    predict = fp_predict(network, result.params, result.state, cfg, device)
    ap = Evaluator(predict, EvalData(cfg), cfg).evaluate()
    print(format_ap_table(ap))
    print(f'AP {ap.AP!r}')


if __name__ == '__main__':
    main()
