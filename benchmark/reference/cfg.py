"""A darknet ``.cfg`` reader for the plain reference, written from the format.

A cfg is a list of ``[section]`` headers, each followed by ``key=value``
lines; ``#`` starts a comment, a comma makes a list. Layer ``i`` is the
``i``-th section after ``[net]``. Only the layer kinds of the benchmark's
detectors are read: convolutional, shortcut, route, upsample and yolo.

``layers(text)`` returns one dict per layer with the shape facts the
reference, the weight maker and the operation counts need: ``kind``,
``cin``, ``cout``, the conv's ``size``, ``stride``, ``pad``, ``groups``,
``bn`` and ``act``, the absolute ``refs`` of a shortcut or route, and the
cumulative ``stride_total`` (the layer output's stride to the input).
"""

from __future__ import annotations

from typing import Dict, List

CONV_DEFAULTS = dict(filters=1, size=1, stride=1, pad=0, padding=0, groups=1,
                     activation='logistic', batch_normalize=0)


def _value(text: str):
    parts = [p.strip() for p in text.split(',') if p.strip()]
    vals = []
    for p in parts:
        try:
            vals.append(int(p))
        except ValueError:
            try:
                vals.append(float(p))
            except ValueError:
                vals.append(p)
    return vals if ',' in text else vals[0]


def sections(text: str) -> List[Dict]:
    out = []
    for raw in text.splitlines():
        line = raw.split('#', 1)[0].strip()
        if not line:
            continue
        if line.startswith('['):
            out.append({'kind': line[1:line.index(']')]})
        else:
            key, val = line.split('=', 1)
            out[-1][key.strip()] = _value(val.strip())
    return out


def layers(text: str) -> List[Dict]:
    """The cfg's layers with channels, refs and strides resolved."""
    secs = sections(text)
    if secs[0]['kind'] != 'net':
        raise ValueError('a cfg starts with [net]')
    cin = int(secs[0].get('channels', 3))
    stride = 1
    out: List[Dict] = []
    for sec in secs[1:]:
        kind = sec['kind']
        i = len(out)

        def absolute(r):
            return i + r if r < 0 else r
        lay = {'kind': kind, 'index': i, 'cin': cin}
        if kind == 'convolutional':
            a = {**CONV_DEFAULTS, **sec}
            pad = a['size'] // 2 if a['pad'] else a['padding']
            stride *= a['stride']
            lay.update(cout=a['filters'], size=a['size'], stride=a['stride'], pad=pad,
                       groups=a['groups'], bn=bool(a['batch_normalize']),
                       act=a['activation'])
        elif kind == 'shortcut':
            lay.update(cout=cin, refs=[absolute(sec['from'])],
                       act=sec.get('activation', 'linear'))
        elif kind == 'route':
            refs = sec['layers'] if isinstance(sec['layers'], list) else [sec['layers']]
            refs = [absolute(r) for r in refs]
            lay.update(refs=refs, cout=sum(out[r]['cout'] for r in refs))
            stride = out[refs[0]]['stride_total']
        elif kind == 'upsample':
            lay.update(cout=cin, stride=sec.get('stride', 2))
            stride //= lay['stride']
        elif kind == 'yolo':
            lay.update(cout=cin, classes=sec['classes'],
                       ignore_thresh=sec.get('ignore_thresh', 0.5),
                       bbox_loss=sec.get('bbox_loss', 'giou'))
        else:
            raise ValueError(f'layer {i}: the reference reads no {kind!r} layer')
        lay['stride_total'] = stride
        out.append(lay)
        cin = lay['cout']
    return out


def conv_layers(lays: List[Dict]) -> List[Dict]:
    return [l for l in lays if l['kind'] == 'convolutional']


def out_sides(lays: List[Dict], size: int) -> Dict[int, int]:
    """{layer index: side of its square output map} at a square input."""
    return {l['index']: size // l['stride_total'] for l in lays}
