"""Graph IR: cfg layer dicts -> a static, validated computation graph.

Where the reference interprets an ``nn.ModuleList`` sequentially at runtime
(model/interpreter.py:38-65), we compile the cfg once into an IR with
channel/stride inference, structural assertions, resolved skip indices and a
liveness analysis, and later walk it node by node.  The IR is
also the substrate the channel pruner operates on (it can mask channels and
re-emit a cfg, mirroring pruning/block.py).

The port's own copy of ``pqdet_tpu/model/graph.py``: it is pure Python, and
the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import IO, List, Optional, Sequence, Tuple, Union

from pqdet_tpu_torch.model.cfgparse import parse_cfg

ACTIVATIONS = ('logistic', 'leaky', 'relu', 'relu6', 'tanh', 'linear', 'mish')


def solve_padding(size: int, padding: int, pad: Union[bool, int]) -> int:
    # reference: model/parser.py:251-252
    return size // 2 if bool(pad) else padding


@dataclasses.dataclass
class Node:
    """One layer of the compiled graph."""
    index: int
    kind: str                       # convolutional/fc/shortcut/.../yolo/dropout
    attrs: dict                     # raw cfg dict (defaults applied)
    in_channels: int
    out_channels: int
    stride: Optional[int]           # cumulative stride vs network input
    # absolute indices of extra inputs (shortcut/scale_channels: 1 entry;
    # route: 1+ entries). The implicit previous-layer input is not listed,
    # except for route which takes only `refs`.
    refs: Tuple[int, ...] = ()
    notprune: bool = False          # protected from channel pruning
    # fixed output spatial size (avgpool), None = inherited
    out_size: Optional[Tuple[int, int]] = None

    @property
    def has_bn(self) -> bool:
        return self.kind == 'convolutional' and self.attrs['batch_normalize'] != 0


class GraphError(ValueError):
    pass


class Graph:
    """A validated detection/classification graph compiled from a cfg."""

    def __init__(self, nodes: List[Node], in_channels: int, cfg_text: Optional[str] = None):
        self.nodes = nodes
        self.in_channels = in_channels
        self.cfg_text = cfg_text
        self.consumers = self._compute_consumers()
        self.last_use = self._compute_last_use()

    # ------------------------------------------------------------------ build

    @classmethod
    def from_cfg(cls, cfg: Union[str, IO], quant: bool = False) -> 'Graph':
        """Compile cfg text / file object / path into a Graph.

        ``quant``: activations are forced to plain relu, matching the
        reference QAT graph restriction (model/parser.py:408-409).
        """
        if hasattr(cfg, 'read'):
            text = cfg.read()
        elif isinstance(cfg, str) and '\n' not in cfg and cfg.endswith('.cfg'):
            with open(cfg, 'r') as fr:
                text = fr.read()
        else:
            text = cfg
        layers = parse_cfg(text)
        return cls.from_layer_dicts(layers, quant=quant, cfg_text=text)

    @classmethod
    def from_layer_dicts(cls, layers: Sequence[dict], quant: bool = False,
                         cfg_text: Optional[str] = None) -> 'Graph':
        nodes: List[Node] = []
        channels = 3
        stride: Optional[int] = 1
        graph_in_channels = 3

        def resolve(rel: int) -> int:
            """cfg refs are relative (negative) or absolute indices."""
            idx = len(nodes) + rel if rel < 0 else rel
            if not 0 <= idx < len(nodes):
                raise GraphError(
                    f'layer[{len(nodes)}]: reference {rel} resolves to {idx}, '
                    f'out of range')
            return idx

        for raw in layers:
            kind = raw['name']
            attrs = dict(raw)
            refs: Tuple[int, ...] = ()
            notprune = False
            out_size = None
            in_channels = channels

            if kind == 'net':
                channels = graph_in_channels = attrs['channels']
                continue
            elif kind == 'convolutional':
                act = attrs['activation']
                if act != 'linear' and act not in ACTIVATIONS:
                    raise GraphError(f'layer[{len(nodes)}]: unknown activation {act!r}')
                if quant and act != 'linear':
                    attrs['activation'] = 'relu'
                groups = attrs['groups']
                if in_channels % groups or attrs['filters'] % groups:
                    raise GraphError(
                        f'layer[{len(nodes)}]: groups={groups} does not divide '
                        f'in={in_channels} / out={attrs["filters"]} channels')
                channels = attrs['filters']
                if stride is not None:
                    stride *= attrs['stride']
            elif kind == 'fc':
                channels = attrs['output']
                if nodes:
                    nodes[-1].notprune = True
            elif kind == 'shortcut':
                src = resolve(attrs['from'])
                if nodes[-1].out_channels != nodes[src].out_channels:
                    raise GraphError(
                        f'shortcut layer[{len(nodes)}]: out channels dont match '
                        f'between layer {len(nodes) - 1}({nodes[-1].out_channels}) '
                        f'and {src}({nodes[src].out_channels})')
                refs = (src,)
                nodes[-1].notprune = True
                nodes[src].notprune = True
            elif kind == 'scale_channels':
                src = resolve(attrs['from'])
                if nodes[-1].out_channels != nodes[src].out_channels:
                    raise GraphError(
                        f'scale_channels layer[{len(nodes)}]: out channels dont '
                        f'match between layer {len(nodes) - 1} and {src}')
                refs = (src,)
                stride = nodes[src].stride
            elif kind == 'route':
                layer_refs = attrs['layers']
                if isinstance(layer_refs, int):
                    layer_refs = [layer_refs]
                refs = tuple(resolve(r) for r in layer_refs)
                strides = {nodes[i].stride for i in refs}
                if len(strides) != 1:
                    raise GraphError(
                        f'route layer[{len(nodes)}]: not all input strides are '
                        f'the same: {[nodes[i].stride for i in refs]}')
                channels = sum(nodes[i].out_channels for i in refs)
                stride = nodes[refs[0]].stride
            elif kind == 'maxpool':
                if stride is not None:
                    stride *= attrs['stride']
            elif kind == 'avgpool':
                out_size = (attrs['height'], attrs['width'])
                stride = None
            elif kind == 'upsample':
                if stride is not None:
                    if stride % attrs['stride']:
                        raise GraphError(
                            f'upsample layer[{len(nodes)}]: cumulative stride '
                            f'{stride} not divisible by {attrs["stride"]}')
                    stride //= attrs['stride']
            elif kind == 'yolo':
                if attrs['bbox_loss'] not in {'diou', 'ciou', 'giou', 'iou', 'l1'}:
                    raise GraphError(
                        f'unsupported bbox loss in yolo layer: {attrs["bbox_loss"]}')
                attrs['stride'] = stride
                nodes[-1].notprune = True
            elif kind == 'dropout':
                pass
            else:
                raise GraphError(f'unsupported layer type: {kind!r}')

            nodes.append(Node(
                index=len(nodes), kind=kind, attrs=attrs,
                in_channels=in_channels, out_channels=channels,
                stride=stride, refs=refs, notprune=notprune, out_size=out_size,
            ))
        return cls(nodes, graph_in_channels, cfg_text=cfg_text)

    # ------------------------------------------------------------- analyses

    def _compute_consumers(self):
        """consumers[i] = indices of nodes whose `refs` include i."""
        consumers = {n.index: [] for n in self.nodes}
        for n in self.nodes:
            for r in n.refs:
                consumers[r].append(n.index)
        return consumers

    def _compute_last_use(self):
        """last_use[i] = last node index that reads output i (for freeing
        cached activations during the traced forward)."""
        last = {}
        for n in self.nodes:
            # implicit previous-output input
            if n.kind != 'route' and n.index > 0:
                last[n.index - 1] = max(last.get(n.index - 1, -1), n.index)
            for r in n.refs:
                last[r] = max(last.get(r, -1), n.index)
        return last

    # ------------------------------------------------------------ utilities

    @property
    def yolo_nodes(self) -> List[Node]:
        return [n for n in self.nodes if n.kind == 'yolo']

    @property
    def output_strides(self) -> List[int]:
        return [n.stride for n in self.yolo_nodes]

    def __len__(self):
        return len(self.nodes)

    def __getitem__(self, i) -> Node:
        return self.nodes[i]

    def summary(self) -> str:
        rows = []
        for n in self.nodes:
            extra = ''
            if n.refs:
                extra = f' refs={list(n.refs)}'
            rows.append(
                f'{n.index:4d} {n.kind:>14s} {n.in_channels:4d}->{n.out_channels:<4d}'
                f' /{n.stride}{extra}')
        return '\n'.join(rows)
