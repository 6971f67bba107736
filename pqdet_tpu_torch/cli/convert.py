"""Conversion CLI (the port of ``pqdet_tpu/cli/convert.py``).

    python -m pqdet_tpu_torch.cli.convert quantize --weight qat.ckpt --out int8.ckpt \
        [--device cuda|cpu]

``quantize`` converts a qat checkpoint (its params, BN statistics and
observers) into a 'quant' checkpoint of int8 weights and edge qparams
(``compress.quantized.convert_to_int8`` and ``save_quantized``), which
either package's ``load_quantized`` reads. The other modes of the JAX CLI
(``stablehlo``, ``onnx``, ``darknet``, ``from-torch``, ``partial``) are
not ported yet and raise.
"""

from __future__ import annotations

import argparse

from pqdet_tpu_torch.config import later

MODES = ('stablehlo', 'onnx', 'darknet', 'from-torch', 'partial', 'quantize')


def main(argv=None):
    parser = argparse.ArgumentParser(description='export / convert')
    parser.add_argument('mode', choices=MODES)
    parser.add_argument('--weight', required=True)
    parser.add_argument('--out', required=True)
    parser.add_argument('--device', default='cuda')
    args, _ = parser.parse_known_args(argv)

    if args.mode != 'quantize':
        raise later(f'convert {args.mode}', 'queue 1, item 10 (exporters and the '
                    'remaining CLIs)')
    from pqdet_tpu_torch.compress.quantized import convert_to_int8, save_quantized
    from pqdet_tpu_torch.model.factory import build_detector
    network, params, state, info = build_detector(None, weight_path=args.weight,
                                                  device=args.device)
    qparams = convert_to_int8(network, params, state)
    save_quantized(args.out, network, qparams, info['cfg_text'], step=info['step'],
                   ap=info['AP'])
    print(f'saved: {args.out}')


if __name__ == '__main__':
    main()
