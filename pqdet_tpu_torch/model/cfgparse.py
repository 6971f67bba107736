"""Darknet-style ``.cfg`` parser.

Grammar (kept compatible with the reference parser, model/parser.py:265-359):

- a file is a sequence of lines; blank lines and lines starting with ``#``
  are skipped; every other line is either a section header ``[name]`` or an
  attribute ``key = value``.
- ``value`` runs to end of line or an inline ``#`` comment; a value containing
  commas is a list.
- scalar values parse as ``int`` when they contain no ``.``, as ``float``
  when they do, and fall back to the raw string (so ``1e-4`` stays a string,
  matching the reference's ``str2value``, model/parser.py:114-120).
- each section starts from a per-layer-type defaults table and is updated by
  the attributes that follow it.
"""

from __future__ import annotations

import re
from typing import IO, Iterator, List, Union

Value = Union[int, float, str, list]

# Per-layer-type default attributes (reference: model/parser.py:43-104).
LAYER_DEFAULTS = {
    'net': {
        'name': 'net',
        'channels': 3,
    },
    'convolutional': {
        'name': 'convolutional',
        'filters': 1,
        'size': 1,
        'stride': 1,
        'pad': 0,
        'padding': 0,
        'groups': 1,
        'activation': 'logistic',
        'batch_normalize': 0,
    },
    'fc': {
        'name': 'fc',
        'input': 1,
        'output': 1,
        'activation': 'logistic',
    },
    'shortcut': {
        'name': 'shortcut',
        'activation': 'linear',
        'alpha': 1,
        'beta': 1,
    },
    'scale_channels': {
        'name': 'scale_channels',
    },
    'route': {
        'name': 'route',
        'layers': -1,
    },
    'maxpool': {
        'name': 'maxpool',
        'size': 1,
        'stride': 1,
        'pad': 0,
        'padding': 0,
    },
    'avgpool': {
        'name': 'avgpool',
        'height': 1,
        'width': 1,
    },
    'upsample': {
        'name': 'upsample',
        'stride': 2,
    },
    'yolo': {
        'name': 'yolo',
        'classes': 1,
        'ignore_thresh': 0.5,
        'bbox_loss': 'giou',
        'l1_loss_gain': 0.1,
        # NOTE: 'exp_cap' (divergence-survival clamp on the decode exp,
        # model/decode.py) is an OPTIONAL yolo attr with no default here:
        # the defaults table stays key-identical to the reference parser
        # (model/parser.py:43-104, test_cfg_grammar_parity). NAS-emitted
        # cfgs write it explicitly.
    },
    'dropout': {
        'name': 'dropout',
        'probability': 0.5,
    },
}

_IDENT_RE = re.compile(r'^[A-Za-z_][A-Za-z0-9_]*')


class CfgSyntaxError(SyntaxError):
    pass


def parse_scalar(text: str) -> Value:
    """Parse one scalar token: int (no dot) / float (dot) / raw string."""
    try:
        if '.' not in text:
            return int(text)
        return float(text)
    except ValueError:
        return text


def parse_value(text: str) -> Value:
    """Parse an attribute value: comma lists become Python lists."""
    if ',' not in text:
        return parse_scalar(text)
    parts = [p for p in text.split(',')]
    # a trailing comma yields an empty final token which the reference's
    # character parser would also produce as ''
    if parts and parts[-1].strip() == '':
        parts = parts[:-1]
    return [parse_scalar(p) for p in parts]


def iter_statements(fp: Union[IO, str]) -> Iterator[tuple]:
    """Yield ('section', name) and ('attr', key, value) tuples."""
    lines = fp.splitlines() if isinstance(fp, str) else fp
    for lineno, raw in enumerate(lines, 1):
        line = raw.strip()
        if not line or line[0] == '#':
            continue
        if line[0] == '[':
            m = _IDENT_RE.match(line[1:])
            if m is None:
                raise CfgSyntaxError(f'line {lineno}: bad section header: {line!r}')
            yield ('section', m.group(0))
            continue
        m = _IDENT_RE.match(line)
        if m is None:
            raise CfgSyntaxError(f'line {lineno}: expected attribute name: {line!r}')
        key = m.group(0)
        rest = line[m.end():].lstrip()
        if not rest.startswith('='):
            raise CfgSyntaxError(f"line {lineno}: expect '=', got {rest[:1]!r}")
        value_text = rest[1:].lstrip()
        # inline comments end the value
        hash_pos = value_text.find('#')
        if hash_pos != -1:
            value_text = value_text[:hash_pos]
        yield ('attr', key, parse_value(value_text.rstrip()))


def parse_cfg(fp: Union[IO, str]) -> List[dict]:
    """Parse a cfg file/str into a list of layer dicts (defaults applied).

    Attribute lines before the first section header are ignored, matching the
    reference generator (model/parser.py:347-359).
    """
    layers: List[dict] = []
    current = None
    for stmt in iter_statements(fp):
        if stmt[0] == 'section':
            if current is not None:
                layers.append(current)
            name = stmt[1]
            if name not in LAYER_DEFAULTS:
                raise CfgSyntaxError(f'unknown layer type: {name!r}')
            current = dict(LAYER_DEFAULTS[name])
            current.setdefault('name', name)
        else:
            if current is not None:
                current[stmt[1]] = stmt[2]
    if current is not None:
        layers.append(current)
    return layers


def emit_cfg(layers: List[dict]) -> str:
    """Serialise layer dicts back into cfg text (used by the pruner to
    re-emit a pruned architecture, reference: pruning/block.py:128-133)."""
    out = []
    for layer in layers:
        name = layer['name']
        out.append(f'[{name}]')
        defaults = LAYER_DEFAULTS.get(name, {})
        for key, val in layer.items():
            if key == 'name':
                continue
            if key in defaults and defaults[key] == val:
                continue
            if isinstance(val, list):
                sval = ', '.join(str(v) for v in val)
            else:
                sval = str(val)
            out.append(f'{key}={sval}')
        out.append('')
    return '\n'.join(out)
