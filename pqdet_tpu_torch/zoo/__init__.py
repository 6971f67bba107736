"""Model zoo: programmatic generators that emit darknet-style cfg text.

The port's copy of ``pqdet_tpu/zoo``: ``mobilenetv2-fpn``, the five RegNet
detectors (``zoo/regnet.py``) and the backbone-pretraining classifiers
(``zoo/classifier.py``), which build ``ClassifierNetwork`` graphs. One
entry has no counterpart in the JAX package: ``yolov3``, YOLOv3 with its
Darknet-53 backbone (``zoo/darknet.py``).
"""

from pqdet_tpu_torch.zoo import classifier as _classifier
from pqdet_tpu_torch.zoo.builder import CfgBuilder
from pqdet_tpu_torch.zoo.darknet import yolov3
from pqdet_tpu_torch.zoo.mobilenetv2 import mobilenetv2_fpn
from pqdet_tpu_torch.zoo.regnet import (regnetx_600m_fpn, regnetx_600m_pan,
                                        regnetx_600m_rpan, regnetx_600m_yolo,
                                        regnety_400m_fpn)

MODEL_ZOO = {
    'mobilenetv2-fpn': mobilenetv2_fpn,
    'regnetx-600m-fpn': regnetx_600m_fpn,
    'regnetx-600m-pan': regnetx_600m_pan,
    'regnety-400m-fpn': regnety_400m_fpn,
    # experimental neck variants the reference ships as cfg files only
    'regnetx-600m-rpan': regnetx_600m_rpan,
    'regnetx-600m-yolo': regnetx_600m_yolo,
    'yolov3': yolov3,
}

CLASSIFIER_ZOO = {
    'resnet50': _classifier.resnet50,
    'regnetx-600m': _classifier.regnetx_600m,
    'regnety-400m': _classifier.regnety_400m,
}


def get_cfg(name: str, num_classes: int = 20, **kwargs) -> str:
    """Return cfg text for a zoo model (``kwargs`` go to the generator,
    e.g. ``width_mult`` for a narrow test model)."""
    return MODEL_ZOO[name](num_classes=num_classes, **kwargs)


def get_classifier_cfg(name: str, num_classes: int = 1000) -> str:
    """Return cfg text for a classifier zoo model."""
    return CLASSIFIER_ZOO[name](num_classes=num_classes)


__all__ = ['CLASSIFIER_ZOO', 'CfgBuilder', 'MODEL_ZOO', 'get_cfg', 'get_classifier_cfg',
           'mobilenetv2_fpn']
