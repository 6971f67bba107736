"""A darknet ``.cfg`` reader for the plain reference, written from the format.

A cfg is a list of ``[section]`` headers, each followed by ``key=value``
lines; ``#`` starts a comment, a comma makes a list. Layer ``i`` is the
``i``-th section after ``[net]``. The layer kinds read are those of the
port's cfg dialect that detectors use: convolutional, shortcut, route,
upsample, yolo, maxpool, avgpool (the global pool only) and
scale_channels. Any other kind (fc, dropout, anything unknown), an avgpool
to another size than 1 x 1, and a maxpool whose output is not its input
divided by its stride raise ``ValueError``, naming the layer.

``layers(text)`` returns one dict per layer with the shape facts the
reference, the weight maker and the operation counts need: ``kind``,
``cin``, ``cout``, the conv's ``size``, ``stride``, ``pad``, ``groups``,
``bn`` and ``act``, a maxpool's ``size``, ``stride`` and ``pad``, the
absolute ``refs`` of a shortcut, route or scale_channels, and the
cumulative ``stride_total`` (the layer output's stride to the input). A
global avgpool is marked ``global``; it and every layer on its 1 x 1
output (a squeeze-excite's convs) are marked ``pooled``, until a
scale_channels puts the result back on its referenced map's grid.
"""

from __future__ import annotations

from typing import Dict, List

CONV_DEFAULTS = dict(filters=1, size=1, stride=1, pad=0, padding=0, groups=1,
                     activation='logistic', batch_normalize=0)
MAXPOOL_DEFAULTS = dict(size=1, stride=1, pad=0, padding=0)


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
    stride, pooled = 1, False
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
            pooled = out[refs[0]].get('pooled', False)
        elif kind == 'upsample':
            lay.update(cout=cin, stride=sec.get('stride', 2))
            stride //= lay['stride']
        elif kind == 'yolo':
            lay.update(cout=cin, classes=sec['classes'],
                       ignore_thresh=sec.get('ignore_thresh', 0.5),
                       bbox_loss=sec.get('bbox_loss', 'giou'))
        elif kind == 'maxpool':
            a = {**MAXPOOL_DEFAULTS, **sec}
            k, s = a['size'], a['stride']
            pad = k // 2 if a['pad'] else a['padding']
            # out = (side + 2 pad - size) // stride + 1 is side / stride at
            # every side divisible by the stride iff size - stride <= 2 pad < size
            if not k - s <= 2 * pad < k:
                raise ValueError(f'layer {i}: a maxpool of size {k}, stride {s} and padding '
                                 f'{pad} does not give its input side / {s}')
            stride *= s
            lay.update(cout=cin, size=k, stride=s, pad=pad)
        elif kind == 'avgpool':
            hw = (sec.get('height', 1), sec.get('width', 1))
            if hw != (1, 1):
                raise ValueError(f'layer {i}: the reference reads only the global avgpool, '
                                 f'not one to {hw}')
            pooled = True
            lay.update({'cout': cin, 'global': True})
        elif kind == 'scale_channels':
            ref = absolute(sec['from'])
            if out[ref]['cout'] != cin:
                raise ValueError(f'layer {i}: scale_channels of {cin} channels over layer '
                                 f"{ref}'s {out[ref]['cout']}")
            lay.update(cout=out[ref]['cout'], refs=[ref])
            stride = out[ref]['stride_total']
            pooled = out[ref].get('pooled', False)
        else:
            raise ValueError(f'layer {i}: the reference reads no {kind!r} layer')
        lay['stride_total'] = stride
        if pooled:
            lay['pooled'] = True
        out.append(lay)
        cin = lay['cout']
    return out


def conv_layers(lays: List[Dict]) -> List[Dict]:
    return [l for l in lays if l['kind'] == 'convolutional']


def out_sides(lays: List[Dict], size: int) -> Dict[int, int]:
    """{layer index: side of its square output map} at a square input: 1
    on a global pool's output."""
    return {l['index']: 1 if l.get('pooled') else size // l['stride_total'] for l in lays}
