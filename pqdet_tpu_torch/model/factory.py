"""Model factory: the network and its weights from a cfg or a checkpoint
(the port of ``pqdet_tpu/model/factory.py``). The checkpoint's ``type``
and the ``qat``/``quantized`` flags drive it as in JAX: a normal model, or
the quant graph with its observers (QAT) and a qat checkpoint's weights
and observers; a quant checkpoint holds int8 weights and loads with
``compress.quantized.load_quantized``. A checkpoint with no cfg given
rebuilds its architecture from the cfg text it embeds.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from pqdet_tpu_torch.compress.qat import prepare_qat_state
from pqdet_tpu_torch.model.network import (DetectionNetwork, cast_params,
                                           densify_grouped_convs, fuse_params)
from pqdet_tpu_torch.train.checkpoint import load_backbone_into, load_weights_into
from pqdet_tpu_torch.utils.codec import load_checkpoint


def build_detector(cfg_text: Optional[str] = None,
                   weight_path: Optional[str] = None,
                   backbone_path: Optional[str] = None,
                   clear_history: bool = False,
                   qat: bool = False,
                   quantized: bool = False,
                   rng_seed: int = 0,
                   device='cuda'):
    """Returns (network, params, state, info) with the weights on ``device``.

    A fresh init draws from ``torch.Generator().manual_seed(rng_seed)``;
    ``backbone_path`` seeds the layers it holds, ``weight_path`` loads a
    normal or qat checkpoint strictly. ``qat``, ``quantized`` or a qat
    checkpoint build the quant graph (plain relu activations) and add the
    observers of ``prepare_qat_state`` (fresh, after a normal checkpoint's
    weights; a qat checkpoint's own, loaded after they exist). info holds
    {step, AP, type, cfg_text} from the checkpoint (step 0 when starting
    fresh or with ``clear_history``).
    """
    info: Dict = {'step': 0, 'AP': None, 'type': 'normal'}
    ckpt = None
    if weight_path:
        ckpt = load_checkpoint(weight_path)
        info['step'] = 0 if clear_history else int(ckpt.get('step', 0))
        ap = ckpt.get('AP', -1.0)
        info['AP'] = None if ap is None or ap < 0 else float(ap)
        info['type'] = ckpt.get('type', 'normal')

    if not cfg_text:
        if ckpt is None:
            raise ValueError('need a model cfg or a checkpoint embedding one')
        cfg_text = ckpt['cfg']
    info['cfg_text'] = cfg_text

    if info['type'] == 'quant':
        raise ValueError('quantized checkpoints hold int8 weights; load them with '
                         'compress.quantized.load_quantized (the bench CLI does)')

    needs_quant_graph = qat or quantized or info['type'] == 'qat'
    network = DetectionNetwork.from_cfg(cfg_text, quant=needs_quant_graph)
    params, state = network.init(torch.Generator().manual_seed(rng_seed), device=device)
    if backbone_path:
        params, state = load_backbone_into(network.graph, params, state,
                                           load_checkpoint(backbone_path))
    if ckpt is not None and info['type'] == 'normal':
        params, state = load_weights_into(network.graph, params, state, ckpt)
    if needs_quant_graph:
        params, state = prepare_qat_state(network, params, state)
        if ckpt is not None and info['type'] == 'qat':
            params, state = load_weights_into(network.graph, params, state, ckpt)
    return network, params, state, info


def inference_params(network, params, state, dtype=None, densify_groups: bool = True) -> Dict:
    """BN-folded params for the inference walk, computed without autograd:
    grouped convs (group width >= 2, the RegNets) densified to
    block-diagonal weights (``densify_grouped_convs``) unless
    ``densify_groups`` is False, as the JAX package's default; optionally
    cast to ``dtype``."""
    with torch.no_grad():
        fused = fuse_params(network, params, state)
        if densify_groups:
            fused = densify_grouped_convs(network, fused)
        return cast_params(fused, dtype) if dtype is not None else fused
