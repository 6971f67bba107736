"""Model zoo: programmatic generators that emit darknet-style cfg text.

The port's copy of ``pqdet_tpu/zoo``; this slice carries
``mobilenetv2-fpn`` only (the RegNets come with the grouped-conv slice).
"""

from pqdet_tpu_torch.zoo.builder import CfgBuilder
from pqdet_tpu_torch.zoo.mobilenetv2 import mobilenetv2_fpn

MODEL_ZOO = {
    'mobilenetv2-fpn': mobilenetv2_fpn,
}


def get_cfg(name: str, num_classes: int = 20, **kwargs) -> str:
    """Return cfg text for a zoo model (``kwargs`` go to the generator,
    e.g. ``width_mult`` for a narrow test model)."""
    return MODEL_ZOO[name](num_classes=num_classes, **kwargs)


__all__ = ['CfgBuilder', 'MODEL_ZOO', 'get_cfg', 'mobilenetv2_fpn']
