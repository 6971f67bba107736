"""Import the torch reference (eleflea/PQDet) for differential validation
(the port's own copy of ``pqdet_tpu/utils/reference_bridge.py``).

The reference tree (its directory in the environment variable
PQDET_REFERENCE, or passed as ``path``) depends
on torchvision and yacs, which neither host of this repository has. This
module installs FUNCTIONAL stubs: a real torch ``batched_nms`` with
torchvision's documented semantics (class-offset boxes, greedy
score-ordered suppression at IoU > threshold) and a minimal attribute-dict
``yacs.config.CfgNode``. It then imports the reference's tools / model /
dataset / eval modules, so the port's weights can run through the
reference's own evaluation pipeline (eval/evaluator.py:44-175).

Used by ``cli/diffeval.py``.
"""

from __future__ import annotations

import os
import sys
import types

DEFAULT_REF = os.environ.get('PQDET_REFERENCE', '')


def _torch_nms_impl():
    import torch

    def nms(boxes, scores, iou_threshold):
        order = torch.argsort(scores, descending=True)
        keep = []
        while order.numel() > 0:
            i = order[0]
            keep.append(i)
            if order.numel() == 1:
                break
            rest = order[1:]
            lt = torch.maximum(boxes[i, :2], boxes[rest, :2])
            rb = torch.minimum(boxes[i, 2:], boxes[rest, 2:])
            wh = (rb - lt).clamp(min=0)
            inter = wh[:, 0] * wh[:, 1]
            area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
            area_r = (boxes[rest, 2] - boxes[rest, 0]) \
                * (boxes[rest, 3] - boxes[rest, 1])
            iou = inter / (area_i + area_r - inter)
            order = rest[iou <= iou_threshold]
        return torch.stack(keep) if keep else \
            torch.zeros(0, dtype=torch.long)

    def batched_nms(boxes, scores, idxs, iou_threshold):
        # torchvision's documented trick: offset boxes per class so no
        # cross-class pair overlaps, then one plain NMS
        if boxes.numel() == 0:
            import torch as _t
            return _t.zeros(0, dtype=_t.long)
        max_coordinate = boxes.max()
        offsets = idxs.to(boxes) * (max_coordinate + 1)
        return nms(boxes + offsets[:, None], scores, iou_threshold)

    return nms, batched_nms


class _CfgNode(dict):
    """Minimal attribute-dict standing in for yacs.config.CfgNode (enough
    for the reference's config.py to import and for tests to build eval
    configs)."""

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name, value):
        self[name] = value

    def clone(self):
        import copy
        return copy.deepcopy(self)

    def freeze(self):
        pass

    def defrost(self):
        pass


def install_stubs():
    if 'torchvision' not in sys.modules:
        nms, batched_nms = _torch_nms_impl()
        tv = types.ModuleType('torchvision')
        tv_ops = types.ModuleType('torchvision.ops')
        tv_ops.boxes = types.SimpleNamespace(batched_nms=batched_nms,
                                             nms=nms)
        tv_ops.nms = nms
        tv.ops = tv_ops
        sys.modules['torchvision'] = tv
        sys.modules['torchvision.ops'] = tv_ops
    if 'yacs' not in sys.modules:
        yacs = types.ModuleType('yacs')
        yacs_config = types.ModuleType('yacs.config')
        yacs_config.CfgNode = _CfgNode
        yacs.config = yacs_config
        sys.modules['yacs'] = yacs
        sys.modules['yacs.config'] = yacs_config


def import_reference(path: str = DEFAULT_REF):
    """Import the reference package; returns a namespace of its modules.

    Import order matters: the reference has a tools <-> interpreter import
    cycle that only resolves when tools loads first.
    """
    if not path or not os.path.isdir(path):
        raise FileNotFoundError(f'reference tree not found at {path!r} (set PQDET_REFERENCE '
                                'to its directory)')
    install_stubs()
    sys.path.insert(0, path)
    try:
        import tools as ref_tools  # noqa
        import model.interpreter as ref_interp  # noqa
        import model.parser as ref_parser  # noqa
        import model.loss as ref_loss  # noqa
        import config as ref_config  # noqa
        import dataset as ref_dataset  # noqa
        import eval.evaluator as ref_evaluator  # noqa
    finally:
        sys.path.remove(path)
    return types.SimpleNamespace(
        tools=ref_tools, interpreter=ref_interp, parser=ref_parser,
        loss=ref_loss, config=ref_config, dataset=ref_dataset,
        evaluator=ref_evaluator, CfgNode=_CfgNode)
