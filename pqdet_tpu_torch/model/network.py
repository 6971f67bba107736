"""Network = Graph + a walk over plain parameter dicts, for inference and
training.

The port of ``pqdet_tpu/model/network.py``. Parameters and BN statistics
are plain dicts of tensors keyed like the JAX pytrees, ``params[str(i)]`` /
``state[str(i)]`` for graph node ``i``, with conv weights in OIHW, so
weights cross 1:1 (``bridge.py``). A conv node whose params hold no
``'bn'`` entry is BN-folded (the fused inference form).

The walk runs eagerly and drops each cached activation as soon as its
last consumer has run (graph liveness).

Inference: with a fused-IR table the walk replaces each [1x1 expand] ->
[dw3x3] -> [1x1 project] chain by one CUDA kernel launch; the raw yolo
heads are kept and decoded after the walk by one launch of the Triton
decode kernel, straight into the (B, sum HWA, 5+C) preds
(``ops/decode_kernel.py::decode_heads``). On CPU tensors both wrappers run
their plain versions; ``plain=True`` asks for the plain versions on any
device (the baseline ``chip_smoke.py`` holds the kernels to). With a
``quant_ctx`` (``compress.qat.QuantCtx``) the walk fake-quantises the
input, every conv weight and every observed output, as the JAX walk does;
int8 serving is ``compress.quantized.Int8Inference``.

Training is its own entry, ``forward_train``, which always returns
(outputs, new BN state) as the JAX ``apply`` does (``train=True``: batch
statistics in BN, dropout from ``rng``; ``targets``: the YOLO loss at each
head). It runs cuDNN convs and autograd and no hand-written kernel, as the
JAX training walk reaches no Pallas kernel:
with ``targets`` each yolo node decodes with the plain ``decode`` at its
node and takes its ``loss_per_scale``; without them the heads go through
the plain, differentiable decode after the walk, as JAX's ``apply`` decodes
with the jnp ``decode``. The kernel wrappers refuse tensors that require
grad. With a ``quant_ctx`` it is the QAT walk of JAX's ``apply``: the
input, every conv weight (per output channel, under autograd) and every
observed edge are fake-quantised, the observers update in
``quant_ctx.new_obs`` when it is ``observing``, and BN runs on batch
statistics (``train``) or frozen on its running ones. Each edge
fake-quantises in f32 and the walk casts the result to ``compute_dtype``,
so every conv takes ``compute_dtype`` and the heads take bf16 in a bf16
walk, as in JAX.
``remat_segments`` N >= 1 runs the walk as N ``torch.utils.checkpoint``
segments over ``np.linspace`` bounds: only the activations that cross a
boundary are kept for the backward pass, the rest is recomputed. A segment
returns its BN state updates, so the recompute never applies them twice,
and replays its dropout draws from the state ``rng`` had when it began.
``s2d_stem`` r runs the stem folded onto space-to-depth(|r|) input
(``ops/space_to_depth.py``; r < 0: the caller ships that layout), in
either walk; it raises ``ValueError`` with a ``quant_ctx`` or for a stem
that does not fold.

Spatial partitioning (``train.spatial``): ``forward_train`` with
``spatial`` (a ``parallel.mesh.SpatialCtx``) walks this rank's band of
rows of the input. Each conv and max pool takes its halo rows from the
neighbouring bands (``parallel/halo.py``), the s2d stem's row padding
included; the global average pool (the SE squeeze) all-reduces its band
sums; BN takes the moments of the whole batch over the world group; each
head decodes at its band's global cell centres and takes its band's share
of the loss, whose box scale is the whole image's. Upsample, route,
shortcut and scale_channels stay band-local. A node fed only by the
replicated squeeze is replicated too and runs unbanded (its BN, if it had
one, over the data group). ``fc`` and ``dropout`` raise: a band holds no
whole feature vector, and a per-band mask would not be the one-process
mask. A padded input (``SpatialCtx.rows``, ``parallel/halo.py``): every
banded node's output is set to 0 past its real height (``real_rows``), a
max pool reads -inf there, and BN, the squeeze, the QAT observers and the
loss (whose padded label cells are all zero, mixup weight included) count
real rows only.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from pqdet_tpu_torch import resolve_device
from pqdet_tpu_torch.model import layers as L
from pqdet_tpu_torch.model.decode import decode
from pqdet_tpu_torch.model.graph import Graph, solve_padding
from pqdet_tpu_torch.model.loss import loss_per_scale, sum_scale_losses
from pqdet_tpu_torch.ops.decode_kernel import (decode_heads, decode_heads_reference,
                                               head_views)
from pqdet_tpu_torch.ops.fused_ir import fused_ir_conv, fused_ir_reference
from pqdet_tpu_torch.ops.space_to_depth import (fold_stem_weight_t, space_to_depth,
                                                stem_foldable)
from pqdet_tpu_torch.parallel.halo import band_real_rows, fill_rows, halo_pad

# stride -> (grid-label index, raw-box index) in the 6-tuple of targets
TARGET_MAP = {8: (0, 3), 16: (1, 4), 32: (2, 5)}
# optional evolved loss hyperparameters, read from the yolo attrs
LOSS_ATTRS = ('bbox_loss_gain', 'conf_loss_gain', 'cls_loss_gain', 'conf_loss_alpha',
              'cls_loss_alpha', 'conf_loss_beta', 'cls_loss_beta')

def _generator_at(rng: Optional[torch.Generator], gen_state):
    """A new generator on ``rng``'s device set to ``gen_state`` (None for
    no ``rng``)."""
    if rng is None:
        return None
    gen = torch.Generator(device=rng.device)
    gen.set_state(gen_state)
    return gen


class Network(nn.Module):
    """Graph executor over plain parameter dicts."""

    def __init__(self, graph: Graph):
        super().__init__()
        self.graph = graph

    @classmethod
    def from_cfg(cls, cfg, quant: bool = False) -> 'Network':
        """``quant``: the QAT/int8 graph, whose activations are plain relu."""
        return cls(Graph.from_cfg(cfg, quant=quant))

    def init(self, gen: torch.Generator, device='cuda') -> Tuple[Dict, Dict]:
        """Random parameters and BN state from ``gen`` (a CPU generator, so
        the numbers do not depend on the device), placed on ``device``."""
        dev = resolve_device(device)
        params: Dict[str, dict] = {}
        state: Dict[str, dict] = {}
        for node in self.graph.nodes:
            if node.kind == 'convolutional':
                a = node.attrs
                p = L.init_conv(gen, node.in_channels, a['filters'], a['size'],
                                groups=a['groups'], bias=not node.has_bn)
                if node.has_bn:
                    p['bn'], state[str(node.index)] = L.init_bn(a['filters'])
                params[str(node.index)] = p
            elif node.kind == 'fc':
                a = node.attrs
                params[str(node.index)] = L.init_linear(gen, a['input'], a['output'])
        return to_device(params, dev), to_device(state, dev)

    def forward(self, params: Dict, state: Dict, x: torch.Tensor,
                compute_dtype: Optional[torch.dtype] = None,
                fused_ir: Optional[Dict] = None, plain: bool = False,
                quant_ctx=None, tap=None, s2d_stem: int = 0):
        """Run the graph on NHWC ``x`` for inference (BN on its running
        statistics). Returns the list of decoded yolo heads, each (B, H, W,
        A, 5+C) f32 (views of the one preds tensor the decode writes), or
        the final activation when the graph has no yolo head.

        ``compute_dtype`` (e.g. bf16) is the dtype carried between nodes;
        ``fused_ir`` is the table of ``ops.fused_ir.prepare_fused_ir`` on
        BN-fused params; ``plain`` runs the kernels' plain versions;
        ``quant_ctx`` adds the QAT fake-quant hooks (the observers' updates
        collect in ``quant_ctx.new_obs``); ``tap(i, x)`` sees each non-yolo
        node's output."""
        x, _, preds, shapes, _ = self._run(params, state, x, compute_dtype, fused_ir, plain,
                                           quant_ctx, None, False, None, 0, tap, s2d_stem)
        return head_views(preds, shapes) if shapes else x

    def forward_train(self, params: Dict, state: Dict, x: torch.Tensor,
                      targets: Optional[tuple] = None, train: bool = True,
                      rng: Optional[torch.Generator] = None,
                      compute_dtype: Optional[torch.dtype] = None, remat_segments: int = 0,
                      tap=None, quant_ctx=None, s2d_stem: int = 0, group=None, spatial=None):
        """The training walk: (outputs, new_state), always. Outputs are the
        per-head loss 4-tuples of ``loss_per_scale`` with ``targets`` (the
        6-tuple of ``ops/labels.py``), else the decoded heads or final
        activation as ``forward`` returns them, the heads through the plain
        decode on every device (differentiable); new_state holds the BN
        running statistics a ``train`` walk computed (``state`` itself
        without ``train``: BN on its running statistics, e.g. for the loss at
        eval statistics). ``rng`` is the generator of the dropout draws;
        ``remat_segments`` as in the module docstring; ``group``, a process
        group of data-parallel ranks, makes train-mode BN take the moments
        of the global batch whose shards the ranks hold (sync-BN,
        ``parallel/mesh.py``); ``spatial``, this rank's ``SpatialCtx``,
        makes ``x`` and ``targets``' grids its band of rows (the module
        docstring; ``group`` is then the world); the other arguments as in
        ``forward``."""
        x, losses, preds, shapes, new_state = self._run(
            params, state, x, compute_dtype, None, True, quant_ctx, targets, train, rng,
            remat_segments, tap, s2d_stem, group, spatial)
        if targets is not None:
            return losses, new_state
        return (head_views(preds, shapes) if shapes else x), new_state

    def _run(self, params, state, x, compute_dtype, fused_ir, plain, quant_ctx, targets,
             train, rng, remat_segments, tap, s2d_stem, group=None, spatial=None):
        """(last activation, per-head losses, preds or None, raw head
        shapes, new state) of one walk."""
        if spatial is not None and targets is None:
            raise ValueError('a spatial walk takes targets: its heads are bands of rows, '
                             'whose loss it sums, not whole heads to decode')
        if s2d_stem and quant_ctx is not None:
            raise ValueError('s2d_stem does not combine with quant_ctx: the stem observer '
                             'would see folded weights')
        if s2d_stem:
            stem = self.graph.nodes[0]
            if not stem_foldable(stem) or stem.attrs['stride'] != abs(s2d_stem):
                raise ValueError(f's2d_stem={s2d_stem} needs a 3-channel ungrouped '
                                 f'stride-{abs(s2d_stem)} stem conv as node 0')
        if remat_segments and (quant_ctx is not None or tap is not None):
            raise ValueError('remat_segments does not combine with quant_ctx or tap: the '
                             'recompute would observe each node twice')
        rows = self.real_rows(spatial.rows) if spatial is not None and spatial.rows else None
        if quant_ctx is not None:
            x = quant_ctx.quantize_input(
                x, None if rows is None else band_real_rows(x.shape[1], spatial.rows, spatial))
        kw = dict(compute_dtype=compute_dtype, plain=plain, targets=targets, train=train,
                  s2d_stem=s2d_stem, group=group, spatial=spatial, rows=rows)
        if remat_segments:
            x, updates, losses, heads = self._segments(params, state, x, rng,
                                                       remat_segments, kw)
        else:
            x, _, updates, losses, heads = self._walk(
                self.graph.nodes, params, state, x, {}, rng, fused_ir=fused_ir,
                quant_ctx=quant_ctx, tap=tap, **kw)
        new_state = {**state, **updates}
        if not heads:
            return x, losses, None, [], new_state
        raws = [r for r, _ in heads]
        preds = decode_all_heads(raws, [n for _, n in heads], plain)
        return x, losses, preds, [r.shape for r in raws], new_state

    def _segments(self, params, state, x, rng, n_segments, kw):
        """The walk as ``n_segments`` checkpointed spans of nodes."""
        nodes = self.graph.nodes
        bounds = np.linspace(0, len(nodes), n_segments + 1).astype(int)
        cache: Dict[int, torch.Tensor] = {}
        updates, losses, heads = {}, [], []
        for k in range(n_segments):
            span = nodes[bounds[k]:bounds[k + 1]]
            if not span:
                continue
            start = None if rng is None else rng.get_state()

            def segment(x, cache, span=span, start=start):
                gen = _generator_at(rng, start)
                out = self._walk(span, params, state, x, cache, gen, **kw)
                return out, None if gen is None else gen.get_state()

            (x, cache, upd, ls, hs), end = checkpoint(
                segment, x, cache, use_reentrant=False, preserve_rng_state=False)
            if rng is not None:
                rng.set_state(end)
            updates.update(upd)
            losses += ls
            heads += hs
        return x, updates, losses, heads

    def real_rows(self, height: int) -> Dict[int, Optional[int]]:
        """The real rows of each node's output for an input ``height`` rows
        high (the unpadded walk's heights; None for a replicated node), by
        the shape rules of each node kind."""
        memo = self.__dict__.setdefault('_real_rows', {})
        if height not in memo:
            rep, out, prev = self.replicated_nodes(), {}, height
            for node in self.graph.nodes:
                i, a, kind = node.index, node.attrs, node.kind
                if i in rep:
                    r = None
                elif kind in ('convolutional', 'maxpool'):
                    pad = solve_padding(a['size'], a['padding'], a['pad'])
                    r = (prev + 2 * pad - a['size']) // a['stride'] + 1
                elif kind == 'upsample':
                    r = prev * a['stride']
                elif kind in ('route', 'scale_channels'):
                    r = next((out[j] for j in node.refs if out.get(j) is not None), prev)
                else:
                    r = prev
                out[i] = prev = r
            memo[height] = out
        return memo[height]

    def replicated_nodes(self) -> frozenset:
        """Indices of the nodes whose output a spatial walk holds whole on
        every band (the global average pool, and what only it feeds)."""
        if getattr(self, '_replicated', None) is None:
            rep = set()
            for node in self.graph.nodes:
                i = node.index
                if node.kind == 'avgpool':
                    rep.add(i)
                elif node.kind == 'route':
                    if all(r in rep for r in node.refs):
                        rep.add(i)
                elif node.kind in ('shortcut', 'scale_channels'):
                    if i - 1 in rep and node.refs[0] in rep:
                        rep.add(i)
                elif i - 1 in rep:
                    rep.add(i)
            self._replicated = frozenset(rep)
        return self._replicated

    def _walk(self, nodes, params, state, x, cache, gen, compute_dtype=None,
              fused_ir=None, plain=False, quant_ctx=None, targets=None, train=False,
              tap=None, s2d_stem=0, group=None, spatial=None, rows=None):
        """Run a contiguous span of graph nodes. Returns (x, live cache, BN
        state updates, per-head losses, [(raw head, yolo node)] to decode).
        ``rows``: ``real_rows`` of a padded spatial input (None: not
        padded)."""
        cache = dict(cache)
        updates: Dict[str, dict] = {}
        losses, heads = [], []
        last_use = self.graph.last_use
        skip = set()
        fused_fn = fused_ir_reference if plain else fused_ir_conv
        rep = self.replicated_nodes() if spatial is not None else frozenset()

        for node in nodes:
            i = node.index
            kind = node.kind
            if i in skip:
                continue
            # this node's band context: None when its input is replicated
            band = spatial if spatial is not None and i - 1 not in rep else None
            # the real rows of its input and output (None: all rows real)
            r_in = r_out = None
            if rows is not None:
                r_in, r_out = rows.get(i - 1, spatial.rows), rows[i]
            if spatial is not None and kind in ('fc', 'dropout'):
                raise ValueError(f'{kind} node {i} under train.spatial: a band of rows holds '
                                 'no whole feature vector' if kind == 'fc' else
                                 f'{kind} node {i} under train.spatial: a mask drawn per band '
                                 'would not be the one-process mask')
            if fused_ir is not None and i in fused_ir:
                f = fused_ir[i]
                x = fused_fn(x.to(torch.bfloat16).contiguous(), f['we'], f['be'],
                             f['wdw'], f['bdw'], f['wp'], f['bp'], act_e=f['act_e'],
                             act_dw=f['act_dw'], act_p=f['act_p'])
                if compute_dtype is not None and x.dtype != compute_dtype:
                    x = x.to(compute_dtype)
                skip.update(f['skip'])
                end = f['end']
                if end in last_use:
                    cache[end] = x
                for j in [j for j in cache if last_use.get(j, -1) <= end and j != end]:
                    del cache[j]
                continue
            p = params.get(str(i))
            if kind == 'convolutional':
                a = node.attrs
                padding = solve_padding(a['size'], a['padding'], a['pad'])
                w = p['w'] if quant_ctx is None else quant_ctx.fake_weights(str(i), p['w'])
                stride = a['stride']
                conv_band = band
                if s2d_stem and i == 0:
                    x, w, stride, padding = s2d_stem_input(x, w, s2d_stem, stride, padding,
                                                           band)
                    conv_band = None        # its halo rows are in place
                x = L.conv2d(x, w, p.get('b'), stride=stride,
                             padding=padding, groups=a['groups'],
                             compute_dtype=compute_dtype, spatial=conv_band,
                             what=f'conv node {i}')
                if 'bn' in p:
                    bn_group = group if spatial is None or band is not None else spatial.data
                    x, bn_s = L.batch_norm(x, p['bn'], state[str(i)], train, bn_group, band,
                                           None if band is None else r_out)
                    if train:
                        updates[str(i)] = bn_s
                x = L.apply_activation(a['activation'], x)
            elif kind == 'fc':
                x = L.linear(x.reshape(x.shape[0], -1), p)
                x = L.apply_activation(node.attrs['activation'], x)
            elif kind == 'shortcut':
                x = x + cache[node.refs[0]]
                x = L.apply_activation(node.attrs['activation'], x)
            elif kind == 'scale_channels':
                x = cache[node.refs[0]] * x
            elif kind == 'route':
                srcs = [cache[r] for r in node.refs]
                x = srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=-1)
            elif kind == 'maxpool':
                a = node.attrs
                padding = solve_padding(a['size'], a['padding'], a['pad'])
                x = L.max_pool(x, a['size'], a['stride'], padding, spatial=band,
                               what=f'maxpool node {i}', rows=r_in)
            elif kind == 'avgpool':
                x = L.adaptive_avg_pool(x, *node.out_size, spatial=band, rows=r_in)
            elif kind == 'upsample':
                x = L.upsample_nearest(x, node.attrs['stride'])
            elif kind == 'yolo':
                if targets is None:
                    heads.append((x, node))
                    if i in last_use:
                        x = decode_consumed_head(x, node, plain)
                else:
                    a = node.attrs
                    h = x.shape[1]
                    x = decode(x, a['classes'], a['stride'], exp_cap=a.get('exp_cap', 0.0),
                               row_offset=band.offset(h) if band is not None else 0)
                    gi, bi = TARGET_MAP[a['stride']]
                    losses.append(loss_per_scale(
                        x, targets[gi], targets[bi], stride=a['stride'],
                        num_classes=a['classes'], bbox_loss_type=a['bbox_loss'],
                        ignore_thresh=a['ignore_thresh'], l1_loss_gain=a['l1_loss_gain'],
                        grid_h=(r_out or h * band.n_space) if band is not None else 0,
                        **{k: a[k] for k in LOSS_ATTRS if k in a}))
            elif kind == 'dropout':
                x = L.dropout(x, node.attrs['probability'], gen, train)
            else:
                raise ValueError(f'unknown layer kind: {kind}')

            real = None
            if r_out is not None and kind != 'yolo':
                # the rows past the real height read as a conv's padding
                x = fill_rows(x, r_out, 0.0, spatial)
                real = band_real_rows(x.shape[1], r_out, spatial)

            if quant_ctx is not None and kind != 'yolo':
                x = quant_ctx.observe_output(str(i), x, real)

            # keep inter-layer activations in the compute dtype
            if compute_dtype is not None and kind != 'yolo' \
                    and x.dtype != compute_dtype:
                x = x.to(compute_dtype)

            if tap is not None and kind != 'yolo':
                tap(i, x)

            if i in last_use:
                cache[i] = x
            # free activations whose consumers have all run
            for j in [j for j in cache if last_use.get(j, -1) <= i and j != i]:
                del cache[j]

        return x, cache, updates, losses, heads


def s2d_stem_input(x, w, s2d_stem: int, stride: int, padding: int, spatial=None):
    """The stem on space-to-depth input: (input, folded OIHW kernel,
    stride 1, padding 0), the folded kernel's asymmetric padding applied to
    the input. ``s2d_stem`` r > 0 reshapes NHWC ``x`` here; r < 0 means the
    caller ships it in the s2d(|r|) layout already. With ``spatial`` ``x``
    is a band of rows (its height a multiple of r): the row padding is a
    halo from the neighbouring bands, zeros at the image's edges."""
    r = abs(s2d_stem)
    if s2d_stem > 0:
        if spatial is not None and x.shape[1] % r:
            raise ValueError(f's2d_stem {r}: a band of {x.shape[1]} rows is not a multiple '
                             f'of {r}')
        x = space_to_depth(x, r)
    w, (ph_lo, ph_hi), (pw_lo, pw_hi) = fold_stem_weight_t(w, r, stride, padding)
    if spatial is not None:
        if max(ph_lo, ph_hi) > x.shape[1]:
            raise ValueError(f's2d stem: a halo of {max(ph_lo, ph_hi)} rows is deeper than '
                             f'the neighbouring band of {x.shape[1]} rows')
        x = halo_pad(x, ph_lo, ph_hi, 0.0, spatial)
        ph_lo = ph_hi = 0
    x = F.pad(x, (0, 0, pw_lo, pw_hi, ph_lo, ph_hi))
    return x, w, 1, 0


def _exp_cap(node, capped: bool) -> float:
    return node.attrs.get('exp_cap', 0.0) if capped else 0.0


def decode_all_heads(raws, nodes, plain: bool, capped: bool = True,
                     dec=None) -> torch.Tensor:
    """The raw heads of yolo ``nodes`` decoded into the (B, sum HWA, 5+C)
    preds: one kernel launch, or the plain version when ``plain`` (or on
    CPU tensors). ``capped``: apply each node's ``exp_cap``. ``dec``, with
    ``decode_heads``'s signature, replaces both (``ops.library``'s
    operator in an exported program)."""
    classes = {n.attrs['classes'] for n in nodes}
    if len(classes) != 1:
        raise ValueError(f'yolo heads with different class counts {sorted(classes)}')
    if dec is None:
        dec = decode_heads_reference if plain else decode_heads
    return dec(raws, classes.pop(), [n.attrs['stride'] for n in nodes],
               [_exp_cap(n, capped) for n in nodes])


def decode_consumed_head(raw, node, plain: bool, capped: bool = True) -> torch.Tensor:
    """The decoded head of yolo ``node`` for a later node that reads it (no
    zoo graph has one). The decode kernel decodes every head at the end of
    the walk, so the kernel path raises; the plain path decodes it here."""
    if not plain and raw.device.type != 'cpu':
        raise NotImplementedError(
            f'yolo node {node.index} is read by a later node: the decode kernel '
            'decodes all heads after the walk, so only the plain path runs this graph')
    a = node.attrs
    return decode(raw, a['classes'], a['stride'], exp_cap=_exp_cap(node, capped))


class DetectionNetwork(Network):
    """Detection graph: inference returns the decoded heads as one
    (B, sum HWA, 5+C) tensor, which the decode writes directly;
    ``forward_train`` with ``targets`` returns (loss dict of
    ``sum_scale_losses``, new state), without them (preds, new state)."""

    @property
    def num_classes(self) -> int:
        return self.graph.yolo_nodes[0].attrs['classes']

    def forward(self, params, state, x, compute_dtype=None, fused_ir=None,
                plain: bool = False, quant_ctx=None, tap=None, s2d_stem: int = 0):
        _, _, preds, _, _ = self._run(params, state, x, compute_dtype, fused_ir, plain,
                                      quant_ctx, None, False, None, 0, tap, s2d_stem)
        return preds

    def forward_train(self, params, state, x, targets=None, train: bool = True, rng=None,
                      compute_dtype=None, remat_segments: int = 0, tap=None, quant_ctx=None,
                      s2d_stem: int = 0, group=None, spatial=None):
        _, losses, preds, _, new_state = self._run(
            params, state, x, compute_dtype, None, True, quant_ctx, targets, train, rng,
            remat_segments, tap, s2d_stem, group, spatial)
        return (sum_scale_losses(losses) if targets is not None else preds), new_state


class ClassifierNetwork(Network):
    """Classifier graph (the zoo's ``CLASSIFIER_ZOO``: a backbone, global
    avgpool and an fc): ``forward`` returns the (B, classes) logits, the
    final activation of the walk."""


def densify_grouped_convs(network: Network, fused: Dict) -> Dict:
    """Expand grouped-conv weights to block-diagonal DENSE (Cout, Cin, kh,
    kw) tensors for inference (the JAX package's ``densify_grouped_convs``
    on OIHW weights).

    A dense conv whose weights are zero outside the group blocks computes
    the grouped conv's function; ``layers.conv2d`` detects the dense shape
    and runs it as one dense conv. Depthwise convs (group width 1) stay
    grouped."""
    out = dict(fused)
    for node in network.graph.nodes:
        key = str(node.index)
        if node.kind != 'convolutional' or key not in fused:
            continue
        g = node.attrs['groups']
        p = fused[key]
        if g <= 1 or p['w'].shape[1] < 2:
            continue
        out[key] = {**p, 'w': L.densify_grouped_weight(p['w'], g)}
    return out


def to_device(tree, device):
    """Move every tensor of a nested dict to ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def fuse_params(network: Network, params: Dict, state: Dict) -> Dict:
    """Fold every conv's BN into its weights -> inference-only params (the
    walk detects the missing 'bn' entries)."""
    fused = {}
    for node in network.graph.nodes:
        key = str(node.index)
        if key not in params:
            continue
        p = params[key]
        if node.kind == 'convolutional' and 'bn' in p:
            fused[key] = L.fold_bn_into_conv(p, p['bn'], state[key])
        else:
            fused[key] = p
    return fused


def cast_params(params: Dict, dtype: torch.dtype) -> Dict:
    """Every floating tensor of ``params`` cast to ``dtype`` once, so a
    walk in that compute dtype does not cast weights on each call."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    if isinstance(params, torch.Tensor) and params.is_floating_point():
        return params.to(dtype)
    return params
