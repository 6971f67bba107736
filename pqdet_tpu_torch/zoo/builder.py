"""Small helper for emitting darknet-style cfg text programmatically."""

from __future__ import annotations

from typing import List, Optional, Sequence, Union


class CfgBuilder:
    """Accumulates cfg sections and tracks layer indices so generators can
    hold on to absolute tap points (for FPN/PAN routes)."""

    def __init__(self, channels: int = 3):
        self.lines: List[str] = ['[net]', f'channels={channels}', '']
        self.index = -1  # index of last emitted layer

    def _section(self, name: str, comment: Optional[str] = None, **attrs) -> int:
        if comment:
            self.lines.append(f'# {comment}')
        self.lines.append(f'[{name}]')
        for k, v in attrs.items():
            if isinstance(v, (list, tuple)):
                v = ', '.join(str(x) for x in v)
            self.lines.append(f'{k}={v}')
        self.lines.append('')
        self.index += 1
        return self.index

    def conv(self, filters: int, size: int = 1, stride: int = 1, groups: int = 1,
             activation: str = 'relu6', bn: bool = True,
             comment: Optional[str] = None) -> int:
        attrs = dict(filters=filters, size=size, stride=stride, pad=1)
        if groups != 1:
            attrs['groups'] = groups
        attrs['batch_normalize'] = int(bn)
        attrs['activation'] = activation
        return self._section('convolutional', comment=comment, **attrs)

    def shortcut(self, frm: int, activation: str = 'linear') -> int:
        return self._section('shortcut', **{'from': frm - self.index - 1,
                                            'activation': activation})

    def scale_channels(self, frm: int) -> int:
        return self._section('scale_channels', **{'from': frm - self.index - 1})

    def route(self, layers: Union[int, Sequence[int]]) -> int:
        if isinstance(layers, int):
            layers = [layers]
        rel = [l - self.index - 1 if l >= 0 else l for l in layers]
        # keep single-entry routes as a bare int (identity passthrough)
        val = rel[0] if len(rel) == 1 else rel
        return self._section('route', layers=val)

    def maxpool(self, size: int, stride: int) -> int:
        return self._section('maxpool', size=size, stride=stride, pad=1)

    def avgpool(self, height: int = 1, width: int = 1) -> int:
        return self._section('avgpool', height=height, width=width)

    def upsample(self, stride: int = 2) -> int:
        return self._section('upsample', stride=stride)

    def yolo(self, classes: int, ignore_thresh: float = 0.5,
             bbox_loss: str = 'giou', l1_loss_gain: float = 0.1,
             exp_cap: float = 0.0) -> int:
        kv = dict(classes=classes, ignore_thresh=ignore_thresh,
                  bbox_loss=bbox_loss, l1_loss_gain=l1_loss_gain)
        if exp_cap:  # optional attr: zoo cfgs stay reference-identical
            kv['exp_cap'] = exp_cap
        return self._section('yolo', **kv)

    def fc(self, inp: int, out: int, activation: str = 'linear') -> int:
        return self._section('fc', input=inp, output=out, activation=activation)

    def dropout(self, probability: float = 0.5) -> int:
        return self._section('dropout', probability=probability)

    def text(self) -> str:
        return '\n'.join(self.lines)
