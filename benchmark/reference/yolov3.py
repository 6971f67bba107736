"""YOLOv3's published layer graph as plain data, to hold a frozen ``.cfg``
to the paper and not only to the generator that wrote it.

The backbone is Table 1 of Redmon & Farhadi, "YOLOv3: An Incremental
Improvement" (arXiv:1804.02767): Darknet-53's rows, each repeated as the
table's left column says, a "Residual" row being darknet's linear
``[shortcut] from=-3``. The head is sections 75-106 of darknet's
``cfg/yolov3.cfg`` (pjreddie/darknet), its relative routes made absolute.
Every conv but the three prediction convs has BN and leaky ReLU 0.1; a
prediction conv has 3 x (5 + classes) filters, a bias, no BN and a linear
output.

``layers(classes)`` lists the 107 layers as ``reference/cfg.layers`` gives
the same facts: ``kind``, and ``filters``, ``size``, ``stride``, ``bn``,
``act`` of a conv, ``refs`` of a shortcut or route, ``stride`` of an
upsample, ``classes`` of a yolo layer.
"""

from __future__ import annotations

from typing import Dict, List

# Table 1: (repeat, [rows]); a row is ('conv', filters, size, stride) or
# ('residual',)
DARKNET53 = [
    (1, [('conv', 32, 3, 1)]),
    (1, [('conv', 64, 3, 2)]),
    (1, [('conv', 32, 1, 1), ('conv', 64, 3, 1), ('residual',)]),
    (1, [('conv', 128, 3, 2)]),
    (2, [('conv', 64, 1, 1), ('conv', 128, 3, 1), ('residual',)]),
    (1, [('conv', 256, 3, 2)]),
    (8, [('conv', 128, 1, 1), ('conv', 256, 3, 1), ('residual',)]),
    (1, [('conv', 512, 3, 2)]),
    (8, [('conv', 256, 1, 1), ('conv', 512, 3, 1), ('residual',)]),
    (1, [('conv', 1024, 3, 2)]),
    (4, [('conv', 512, 1, 1), ('conv', 1024, 3, 1), ('residual',)]),
]

# yolov3.cfg's head: (layer, section); 'pred' is the prediction conv
HEAD = [
    (75, ('conv', 512, 1, 1)), (76, ('conv', 1024, 3, 1)), (77, ('conv', 512, 1, 1)),
    (78, ('conv', 1024, 3, 1)), (79, ('conv', 512, 1, 1)), (80, ('conv', 1024, 3, 1)),
    (81, ('pred',)), (82, ('yolo',)),
    (83, ('route', [79])), (84, ('conv', 256, 1, 1)), (85, ('upsample', 2)),
    (86, ('route', [85, 61])),
    (87, ('conv', 256, 1, 1)), (88, ('conv', 512, 3, 1)), (89, ('conv', 256, 1, 1)),
    (90, ('conv', 512, 3, 1)), (91, ('conv', 256, 1, 1)), (92, ('conv', 512, 3, 1)),
    (93, ('pred',)), (94, ('yolo',)),
    (95, ('route', [91])), (96, ('conv', 128, 1, 1)), (97, ('upsample', 2)),
    (98, ('route', [97, 36])),
    (99, ('conv', 128, 1, 1)), (100, ('conv', 256, 3, 1)), (101, ('conv', 128, 1, 1)),
    (102, ('conv', 256, 3, 1)), (103, ('conv', 128, 1, 1)), (104, ('conv', 256, 3, 1)),
    (105, ('pred',)), (106, ('yolo',)),
]


def layers(classes: int = 80) -> List[Dict]:
    """The 107 layers of YOLOv3 at ``classes`` classes."""
    out: List[Dict] = []
    for repeat, rows in DARKNET53:
        for _ in range(repeat):
            for row in rows:
                if row[0] == 'conv':
                    _, filters, size, stride = row
                    out.append({'kind': 'convolutional', 'filters': filters, 'size': size,
                                'stride': stride, 'bn': True, 'act': 'leaky'})
                else:
                    out.append({'kind': 'shortcut', 'refs': [len(out) - 3], 'act': 'linear'})
    for index, row in HEAD:
        if index != len(out):
            raise ValueError(f'the head starts at layer {len(out)}, not {index}')
        kind = row[0]
        if kind == 'conv':
            _, filters, size, stride = row
            out.append({'kind': 'convolutional', 'filters': filters, 'size': size,
                        'stride': stride, 'bn': True, 'act': 'leaky'})
        elif kind == 'pred':
            out.append({'kind': 'convolutional', 'filters': 3 * (5 + classes), 'size': 1,
                        'stride': 1, 'bn': False, 'act': 'linear'})
        elif kind == 'route':
            out.append({'kind': 'route', 'refs': list(row[1])})
        elif kind == 'upsample':
            out.append({'kind': 'upsample', 'stride': row[1]})
        else:
            out.append({'kind': 'yolo', 'classes': classes})
    return out
