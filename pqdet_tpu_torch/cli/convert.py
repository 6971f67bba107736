"""Conversion and export CLI (the port of ``pqdet_tpu/cli/convert.py``).

    python -m pqdet_tpu_torch.cli.convert quantize --weight qat.ckpt --out int8.ckpt
    python -m pqdet_tpu_torch.cli.convert stablehlo --weight m.ckpt --out m.pt2 \
        [--size 512] [--bs 1] [--nms]
    python -m pqdet_tpu_torch.cli.convert onnx --weight m.ckpt --out m.onnx [--size] [--bs]
    python -m pqdet_tpu_torch.cli.convert darknet --weight m.ckpt --out m.weights
    python -m pqdet_tpu_torch.cli.convert from-torch --weight ref.pt --out m.ckpt
    python -m pqdet_tpu_torch.cli.convert partial --weight m.ckpt --out bb.ckpt --layers 61

Every mode takes ``--device cuda|cpu`` (default cuda; raises without a
card unless ``--device cpu``).

- ``quantize`` converts a qat checkpoint (its params, BN statistics and
  observers) into a 'quant' checkpoint of int8 weights and edge qparams;
- ``stablehlo`` writes a ``torch.export`` program (a ``.pt2`` archive, not
  StableHLO; ``exporters/export.py``) for ``--bs`` images of ``--size``²:
  the fp BN-folded walk, with ``--nms`` also the NMS, or for a 'quant'
  checkpoint the int8 executor in ``mode='int'`` (plain PyTorch ops; the
  kernel artifact, ``mode='kernel'``, is written through the API, as the
  JAX CLI leaves ``'pallas'`` to its API);
- ``onnx`` exports fp checkpoints with ``export_normal_to_onnx`` and
  'quant' checkpoints with ``export_quantized_to_onnx``: the checkpoint
  type selects the graph;
- ``darknet`` writes darknet ``.weights``; ``from-torch`` converts a
  reference ``.pt`` checkpoint; ``partial`` keeps the graph nodes up to
  ``--layers``.
"""

from __future__ import annotations

import argparse

from pqdet_tpu_torch import resolve_device

MODES = ('stablehlo', 'onnx', 'darknet', 'from-torch', 'partial', 'quantize')


def _write(path: str, blob: bytes):
    with open(path, 'wb') as fw:
        fw.write(blob)


def main(argv=None):
    parser = argparse.ArgumentParser(description='export / convert')
    parser.add_argument('mode', choices=MODES)
    parser.add_argument('--weight', required=True)
    parser.add_argument('--out', required=True)
    parser.add_argument('--size', type=int, default=512)
    parser.add_argument('--bs', type=int, default=1)
    parser.add_argument('--nms', action='store_true')
    parser.add_argument('--layers', type=int, default=0)
    parser.add_argument('--device', default='cuda')
    args, _ = parser.parse_known_args(argv)
    dev = resolve_device(args.device)
    size = (args.size, args.size)

    if args.mode == 'from-torch':
        from pqdet_tpu_torch.exporters.torch_convert import convert_torch_checkpoint
        convert_torch_checkpoint(args.weight, args.out)
    elif args.mode == 'partial':
        from pqdet_tpu_torch.exporters.export import partial_checkpoint
        partial_checkpoint(args.weight, args.out, args.layers)
    elif args.mode in ('onnx', 'stablehlo') and _is_quant(args.weight):
        from pqdet_tpu_torch.compress.quantized import load_quantized
        network, qparams = load_quantized(args.weight, device=dev)
        if args.mode == 'onnx':
            from pqdet_tpu_torch.exporters.onnx_export import export_quantized_to_onnx
            blob = export_quantized_to_onnx(network, qparams, size, batch_size=args.bs)
        else:
            from pqdet_tpu_torch.exporters.export import export_stablehlo_quant
            blob = export_stablehlo_quant(network, qparams, input_size=size,
                                          batch_size=args.bs, device=dev)
        _write(args.out, blob)
    else:
        _from_detector(args, dev, size)
    print(f'saved: {args.out}')


def _is_quant(path: str) -> bool:
    from pqdet_tpu_torch.utils.codec import load_checkpoint
    return load_checkpoint(path).get('type') == 'quant'


def _from_detector(args, dev, size):
    """The modes that start from ``build_detector``: quantize, darknet and
    the fp onnx and stablehlo exports."""
    from pqdet_tpu_torch.model.factory import build_detector, inference_params
    network, params, state, info = build_detector(None, weight_path=args.weight, device=dev)
    if args.mode == 'quantize':
        from pqdet_tpu_torch.compress.quantized import convert_to_int8, save_quantized
        qparams = convert_to_int8(network, params, state)
        save_quantized(args.out, network, qparams, info['cfg_text'], step=info['step'],
                       ap=info['AP'])
    elif args.mode == 'darknet':
        from pqdet_tpu_torch.exporters.export import save_weights_darknet
        save_weights_darknet(network, params, state, args.out)
    elif args.mode == 'onnx':
        from pqdet_tpu_torch.exporters.onnx_export import export_normal_to_onnx
        _write(args.out, export_normal_to_onnx(network, inference_params(network, params, state),
                                               size, batch_size=args.bs))
    else:
        from pqdet_tpu_torch.exporters.export import export_stablehlo
        _write(args.out, export_stablehlo(network, inference_params(network, params, state),
                                          input_size=size, batch_size=args.bs,
                                          with_nms=args.nms, device=dev))


if __name__ == '__main__':
    main()
