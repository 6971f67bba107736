"""The training step: loss -> grads (autograd) -> Adam (the port of
``pqdet_tpu/train/step.py``).

The step is a function of plain dicts, as in JAX: it takes params, BN
state and optimizer state and returns new ones, writing none of its inputs
in place. The learning rate is a schedule of the update count inside the
optimizer; sparse training's BN-gamma L1 subgradient is added to the
grads before it. With device augmentation the batch is augmented in the
step before its labels are built. The QAT step (``make_qat_train_step``)
runs the fake-quant walk of the quant graph with the same Adam. On the card either
step runs cuDNN convs, PyTorch elementwise kernels and autograd, and
launches no hand-written kernel: the JAX step reaches no Pallas kernel
either.

Data parallelism (``parallel/mesh.py``): built with a process ``group``,
the step runs on this rank's shard of the global batch and computes what
the one-process step computes on the whole batch, as JAX's sharded step
does: sync-BN in the walk, the QAT observers of the global batch, the
grads averaged by one all-reduce of their flat f32 vector before sparse-L1
(which is of the replicated params, added once) and before the
global-norm clip (which must see the global gradient), and the metrics
all-reduced (the loss and its parts are batch means, so with equal local
batches the mean of the ranks' means is the global mean; ``head_max`` by
MAX). Device augmentation gathers the global batch, augments it with the
global draws (in-batch partners span the global batch) and keeps this
rank's rows. Without a group (world size 1) none of this runs.

Spatial partitioning (``train.spatial``): built with a ``spatial`` context
(``parallel/mesh.py::SpatialCtx``), rank (d, s) holds data shard d's rows
at full height. The step labels the whole image (the grids of the global
input size), then cuts band s of the image's rows and of each label grid's
rows (the GT box lists stay whole), and walks the band
(``model/network.py``). Each rank's loss is its band's share of its data
shard's loss, so the global loss is the sum over the world divided by the
data shards: the grads and the loss metrics are all-reduced by SUM and
divided by ``n_data`` (the mean over the world at ``n_space`` 1). With
device augmentation each rank gathers the global batch over its ``data``
group, augments it, keeps its data rows and only then cuts its band. An
image height that the bands x the total stride do not divide is padded
(``_spatial_inputs``, ``parallel/halo.py``): the walk masks the padding
out and the step computes the unpadded image's loss and grads.

Unrolled steps (``train.unroll_steps``): ``make_multi_step`` runs K steps
on K stacked same-size batches as a plain loop, where JAX scans them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Set

import numpy as np
import torch

from pqdet_tpu_torch.compress.qat import QuantCtx
from pqdet_tpu_torch.ops.augment_device import augmenter_from_config
from pqdet_tpu_torch.ops.labels import label_assigner_from_config
from pqdet_tpu_torch.ops.preprocess import device_normalize
from pqdet_tpu_torch.parallel.mesh import all_gather_batch, all_reduce_mean_, rank, world
from pqdet_tpu_torch.train.schedule import build_schedule

COMPUTE_DTYPES = {'float32': None, 'bfloat16': torch.bfloat16}


def sparse_bn_gamma_ids(network) -> Set[str]:
    """Graph node ids whose BN gamma receives the L1 sparsity subgradient:
    conv+BN layers not protected by ``notprune``."""
    return {str(node.index) for node in network.graph.nodes
            if node.kind == 'convolutional' and node.has_bn and not node.notprune}


def add_sparse_l1(grads, params, sparse_ids: Set[str], ratio: float):
    """grad(gamma) += ratio * sign(gamma) for the selected BN layers."""
    out = {}
    for key, g in grads.items():
        if key in sparse_ids and 'bn' in g:
            bn_g = dict(g['bn'])
            bn_g['gamma'] = bn_g['gamma'] + ratio * torch.sign(params[key]['bn']['gamma'])
            g = {**g, 'bn': bn_g}
        out[key] = g
    return out


def tree_leaves(tree) -> list:
    """The tensors of a nested dict, depth first in insertion order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves):
    """A nested dict shaped like ``like`` holding ``leaves`` in the order of
    ``tree_leaves(like)``."""
    it = iter(leaves)

    def build(t):
        return {k: build(v) for k, v in t.items()} if isinstance(t, dict) else next(it)
    return build(like)


def _detach(tree):
    if isinstance(tree, dict):
        return {k: _detach(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_detach(v) for v in tree)
    return tree.detach() if isinstance(tree, torch.Tensor) else tree


class Adam:
    """The JAX package's optax chain, update for update: global-norm clip
    (optax's form, ``g / |g| * max_norm`` when |g| >= max_norm), then L2
    (``g + weight_decay * param``, not AdamW), then Adam (b1 0.9, b2 0.999,
    eps 1e-8, bias correction from count 1), then ``-lr``, where update k
    (0-based) takes ``schedule(k)``.

    It runs on one flat f32 vector of all leaves, as ``optax.flatten`` does
    in JAX: every step is a handful of elementwise kernels over it, and the
    global norm is that vector's norm. The state is a dict: ``count`` (the
    bias corrections' update count) and ``schedule_count`` (the lr's), both
    Python ints so the schedule is plain Python, and ``mu`` and ``nu``
    (flat f32 on the params' device). The two counts move together; a
    resumed run sets ``schedule_count`` alone (``resume_schedule_step``),
    as the JAX package fast-forwards optax's schedule count and leaves
    Adam's at 0."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, schedule: Callable[[int], float], weight_decay: float = 0.0,
                 grad_clip: float = 0.0):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def init(self, params) -> dict:
        flat = torch.cat([t.reshape(-1) for t in tree_leaves(params)]).float()
        return {'count': 0, 'schedule_count': 0, 'mu': torch.zeros_like(flat),
                'nu': torch.zeros_like(flat)}

    def update(self, grads, opt_state: dict, params):
        """(new params, new optimizer state) after one update with ``grads``."""
        leaves = tree_leaves(params)
        g = torch.cat([t.reshape(-1) for t in tree_leaves(grads)]).float()
        p = torch.cat([t.reshape(-1) for t in leaves])
        if self.grad_clip:
            g_norm = torch.linalg.vector_norm(g)
            g = torch.where(g_norm < self.grad_clip, g, (g / g_norm) * self.grad_clip)
        if self.weight_decay:
            g = g + self.weight_decay * p
        count = opt_state['count'] + 1
        mu = (1 - self.b1) * g + self.b1 * opt_state['mu']
        nu = (1 - self.b2) * g ** 2 + self.b2 * opt_state['nu']
        # bias corrections in f32, as optax computes them
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
        new = p + u * -float(self.schedule(opt_state['schedule_count']))
        out = [t.view(like.shape)
               for t, like in zip(torch.split(new, [t.numel() for t in leaves]), leaves)]
        return tree_unflatten(params, out), {
            'count': count, 'schedule_count': opt_state['schedule_count'] + 1,
            'mu': mu, 'nu': nu}


def resume_schedule_step(opt_state: dict, step: int) -> dict:
    """Fast-forward the lr schedule to ``step`` after a checkpoint resume,
    so the next update takes ``schedule(step)``; Adam's count and moments
    start fresh."""
    return {**opt_state, 'schedule_count': int(step)}


def make_optimizer(schedule: Callable[[int], float], weight_decay: float = 0.0,
                   grad_clip: float = 0.0) -> Adam:
    """Adam with torch-default betas and eps, optional L2 and global-norm
    clip, and the learning rate of ``schedule``."""
    return Adam(schedule, weight_decay=weight_decay, grad_clip=grad_clip)


def _band(t, spatial, height=None, fn=None):
    """Band ``spatial.s`` of NHWC-like ``t``'s rows (dim 1) as a tensor
    ``height`` rows high (default: ``t``'s) would cut it: ``fn`` (if any)
    applied to the band's rows of ``t``, then zero rows where the band
    reaches past ``t``."""
    hb = (height or t.shape[1]) // spatial.n_space
    part = t[:, spatial.s * hb:(spatial.s + 1) * hb]
    if fn is not None:
        part = fn(part)
    if part.shape[1] < hb:
        part = torch.cat([part, part.new_zeros((part.shape[0], hb - part.shape[1])
                                               + part.shape[2:])], 1)
    return part


def _spatial_inputs(batch, label_fn, augment_fn, spatial, total_stride):
    """(normalized image band, targets, ``SpatialCtx``) of a spatial step:
    the full-height rows of this rank's data shard augmented (in-batch
    partners gathered over the ``data`` group) and labelled as the whole
    image, then band ``spatial.s`` of the image's rows and of each label
    grid's rows; the box lists stay whole. An image height that the bands x
    ``total_stride`` do not divide is padded with zero rows (after the
    normalization: a conv's padding) to ``padded_height``, its label
    grids with all-zero cells (no loss term counts them: the mixup weight
    is 0), and the context returned carries the real height (``rows``)."""
    if 'gt' not in batch:
        raise ValueError("train.spatial needs system.label_assign 'device': the step labels "
                         'the whole image before it cuts the bands')
    image, gt = batch['image'], batch['gt']
    height = image.shape[1]
    padded = spatial.padded_height(height, total_stride)
    if augment_fn is not None:
        b = image.shape[0]
        image, gt = augment_fn(all_gather_batch(image, spatial.data),
                               all_gather_batch(gt, spatial.data), batch['draws'],
                               batch.get('partner_image'), batch.get('partner_gt'))
        rows = slice(spatial.d * b, (spatial.d + 1) * b)
        image, gt = image[rows], gt[rows]
    targets = label_fn(gt, image.shape[1:3])
    k = len(targets) // 2
    if padded != height:
        spatial = dataclasses.replace(spatial, rows=height)
    grids = tuple(_band(t, spatial, padded * t.shape[1] // height) for t in targets[:k])
    return (_band(image, spatial, padded, device_normalize), grids + tuple(targets[k:]),
            spatial)


def _inputs(batch, label_fn, augment_fn=None, group=None):
    """(normalized image, label targets) of a step's batch: augmented on
    the device first when ``augment_fn`` is given and the batch has
    ``gt``; with a ``group``, as this rank's rows of the augmented global
    batch (the draws are the global batch's)."""
    if augment_fn is not None and 'gt' in batch:
        image, gt = batch['image'], batch['gt']
        if group is not None:
            image, gt = all_gather_batch(image, group), all_gather_batch(gt, group)
        raw, gt = augment_fn(image, gt, batch['draws'],
                             batch.get('partner_image'), batch.get('partner_gt'))
        if group is not None:
            b, r = batch['image'].shape[0], rank(group)
            raw, gt = raw[r * b:(r + 1) * b], gt[r * b:(r + 1) * b]
        image = device_normalize(raw)
        return image, label_fn(gt, image.shape[1:3])
    image = device_normalize(batch['image'])
    if 'targets' in batch:
        return image, batch['targets']
    return image, label_fn(batch['gt'], image.shape[1:3])


def make_loss_fn(network, compute_dtype=None, remat: int = 0, label_fn=None,
                 augment_fn=None, probe_heads: bool = False, s2d_stem: int = 0,
                 group=None, spatial=None):
    """The (params, state, batch, rng) -> (loss, (losses, new_state, stats))
    function of the step: normalize a uint8 batch on the device, build the
    label grids from its padded GT boxes with ``label_fn`` (or take its
    ``targets``), and run the train walk with the YOLO loss.

    batch: a dict with ``image`` (B, H, W, 3) uint8 (float passes through,
    normalized on the host) and either ``gt`` (B, max_gt, 6) padded raw GT
    boxes or ``targets``, the 6-tuple of ``ops/labels.py``. ``remat`` N >= 1
    runs the walk as N checkpointed segments. ``probe_heads``: ``stats``
    holds the max |activation| of each yolo head's input conv.

    ``augment_fn`` (``ops/augment_device.py::augmenter_from_config``)
    augments a ``gt`` batch on the device first, with the batch's
    ``draws`` (an ``AugmentDraws``) and its fresh partner rows
    ``partner_image`` / ``partner_gt`` when it has them; the label grids
    are then built from the grown GT. The draws are the batch's own, apart
    from ``rng`` (the dropout generator), as JAX splits the step's key.
    ``s2d_stem`` runs the stem folded onto space-to-depth input; the fold
    is differentiable, so the grads reach the stem's own kernel. ``group``:
    this rank's shard of a data-parallel batch; ``spatial``: this rank's
    band of it (the module docstring; ``group`` is then the world)."""
    remat_n = int(remat)
    inputs = _make_inputs(network, label_fn, augment_fn, group, spatial)
    head_in = tuple(n.index - 1 for n in network.graph.yolo_nodes) if probe_heads else ()
    if head_in and remat_n:
        raise ValueError('probe_heads does not combine with remat: the head taps would '
                         'run inside checkpointed segments')

    def loss_fn(params, state, batch, rng: Optional[torch.Generator] = None):
        stats = {}
        tap = None
        if head_in:
            def tap(i, t):
                if i in head_in:
                    stats[i] = t.detach().abs().amax().float()
        image, targets, band = inputs(batch)
        losses, new_state = network.forward_train(params, state, image, targets=targets,
                                                  rng=rng, compute_dtype=compute_dtype,
                                                  remat_segments=remat_n, tap=tap,
                                                  s2d_stem=s2d_stem, group=group,
                                                  spatial=band)
        return losses['loss'][0], (losses, new_state, stats)

    return loss_fn


def _make_inputs(network, label_fn, augment_fn, group, spatial):
    """The batch -> (image, targets, spatial context of the walk) function
    of a step: ``_inputs`` (no context), or ``_spatial_inputs`` with the
    graph's total stride. It looks ``_inputs`` up at each call, so a caller
    may wrap it."""
    if spatial is None:
        return lambda batch: (*_inputs(batch, label_fn, augment_fn, group), None)
    total_stride = max(n.stride for n in network.graph.nodes if n.stride is not None)
    return lambda batch: _spatial_inputs(batch, label_fn, augment_fn, spatial, total_stride)


def value_and_grad(loss_fn, params, state, batch, rng=None):
    """((loss, aux), grads) of ``loss_fn`` at ``params``, all detached;
    grads are shaped like params (zeros for a leaf the loss does not
    reach)."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(params)]
    loss, aux = loss_fn(tree_unflatten(params, leaves), state, batch, rng)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]
    return (loss.detach(), _detach(aux)), tree_unflatten(params, grads)


def make_train_step(network, optimizer: Adam, sparse_ratio: float = 0.0,
                    sparse_ids: Optional[Set[str]] = None, compute_dtype=None,
                    remat: int = 0, label_fn=None, augment_fn=None,
                    probe_heads: bool = False, s2d_stem: int = 0, group=None,
                    spatial=None):
    """The (params, state, opt_state, batch, rng) -> (params, new_state,
    opt_state, metrics) step. ``batch``, ``remat``, ``probe_heads`` and
    ``s2d_stem`` as in ``make_loss_fn``; ``rng`` is the generator of the dropout draws (on
    the batch's device). Metrics: ``loss`` and its parts ``giou_loss``,
    ``conf_loss``, ``class_loss`` (0-d), ``loss_per_branch`` (one per
    head), and with ``probe_heads`` ``head_max`` (one per head), all
    detached on the device; with a ``group`` the global batch's, with
    ``spatial`` (a ``SpatialCtx``; the world is its group) the global
    batch's over the bands too (the module docstring)."""
    group = spatial.world if spatial is not None else group
    loss_fn = make_loss_fn(network, compute_dtype=compute_dtype, remat=remat,
                           label_fn=label_fn, augment_fn=augment_fn,
                           probe_heads=probe_heads, s2d_stem=s2d_stem, group=group,
                           spatial=spatial)
    return _step_of(loss_fn, optimizer, sparse_ratio, sparse_ids, probe_heads, group,
                    _shards(group, spatial))


def _shards(group, spatial) -> int:
    """The divisor of the summed grads and metrics: the data shards."""
    return spatial.n_data if spatial is not None else world(group)


def make_qat_loss_fn(network, observing: bool = True, bn_frozen: bool = False,
                     compute_dtype=None, label_fn=None, augment_fn=None, group=None,
                     spatial=None):
    """The loss function of the QAT step, in ``make_loss_fn``'s contract:
    augment, normalize and label as there, then the fake-quant walk with
    ``QuantCtx(state['quant'], observing)`` and BN on batch statistics
    unless ``bn_frozen``; the new observers go into the new state's
    ``quant`` (``state``'s own when not ``observing``). Under ``spatial``
    the observers take the min and max over the world: the whole image."""
    inputs = _make_inputs(network, label_fn, augment_fn, group, spatial)

    def loss_fn(params, state, batch, rng: Optional[torch.Generator] = None):
        ctx = QuantCtx(state['quant'], observing=observing, group=group)
        image, targets, band = inputs(batch)
        losses, new_state = network.forward_train(params, state, image, targets=targets,
                                                  train=not bn_frozen, rng=rng,
                                                  compute_dtype=compute_dtype, quant_ctx=ctx,
                                                  group=group, spatial=band)
        new_state = {**new_state, 'quant': ctx.new_obs}
        return losses['loss'][0], (losses, new_state, {})

    return loss_fn


def make_qat_train_step(network, optimizer: Adam, observing: bool = True,
                        bn_frozen: bool = False, compute_dtype=None, label_fn=None,
                        augment_fn=None, group=None, spatial=None):
    """The QAT step, the port of the JAX trainer's ``_wrap_quant_step``:
    ``make_train_step``'s contract with the loss of ``make_qat_loss_fn``
    for one phase of the observer and BN-freeze schedule, and the same
    Adam. Like JAX's it has no sparse L1, no remat and no head probe, and
    it launches no hand-written kernel (the fake-quant is PyTorch ops
    under autograd)."""
    group = spatial.world if spatial is not None else group
    loss_fn = make_qat_loss_fn(network, observing=observing, bn_frozen=bn_frozen,
                               compute_dtype=compute_dtype, label_fn=label_fn,
                               augment_fn=augment_fn, group=group, spatial=spatial)
    return _step_of(loss_fn, optimizer, group=group, shards=_shards(group, spatial))


def average_grads(grads, group, shards: int):
    """``grads`` summed over the ranks of ``group`` and divided by
    ``shards`` (the ranks: the mean; the data shards under spatial
    partitioning, where the bands' grads are parts of one shard's grad):
    one all-reduce of their flat f32 vector."""
    leaves = tree_leaves(grads)
    flat = all_reduce_mean_(torch.cat([t.reshape(-1).float() for t in leaves]), group, shards)
    return tree_unflatten(grads, [part.view(t.shape) for part, t in
                                  zip(torch.split(flat, [t.numel() for t in leaves]), leaves)])


def reduce_metrics(metrics: dict, group, shards: int) -> dict:
    """The step's metrics of the global batch: the loss and its parts
    summed over the ranks in one collective and divided by ``shards`` (as
    ``average_grads``), ``head_max`` to its maximum."""
    names = [k for k in metrics if k != 'head_max']
    flat = all_reduce_mean_(torch.cat([metrics[k].reshape(-1).float() for k in names]),
                            group, shards)
    out = {k: part.view(metrics[k].shape) for k, part in
           zip(names, torch.split(flat, [metrics[k].numel() for k in names]))}
    if 'head_max' in metrics:
        out['head_max'] = metrics['head_max'].clone()
        torch.distributed.all_reduce(out['head_max'], op=torch.distributed.ReduceOp.MAX,
                                     group=group)
    return out


def _step_of(loss_fn, optimizer: Adam, sparse_ratio: float = 0.0,
             sparse_ids: Optional[Set[str]] = None, probe_heads: bool = False, group=None,
             shards: int = 1):
    """The train step around ``loss_fn``: grads (summed over ``group``'s
    ranks, divided by ``shards``), sparse-L1, the update and the metrics."""
    def train_step(params, state, opt_state, batch, rng=None):
        (_, (losses, new_state, stats)), grads = value_and_grad(
            loss_fn, params, state, batch, rng)
        if group is not None:
            grads = average_grads(grads, group, shards)
        if sparse_ratio and sparse_ids:
            grads = add_sparse_l1(grads, params, sparse_ids, sparse_ratio)
        params, opt_state = optimizer.update(grads, opt_state, params)
        metrics = {
            'loss': losses['loss'][0],
            'giou_loss': losses['giou_loss'][0],
            'conf_loss': losses['conf_loss'][0],
            'class_loss': losses['class_loss'][0],
            'loss_per_branch': torch.stack([b[0] for b in losses['loss_per_branch']]),
        }
        if probe_heads:     # the head inputs in graph order, as the yolo nodes
            metrics['head_max'] = torch.stack([stats[i] for i in sorted(stats)])
        if group is not None:
            metrics = reduce_metrics(metrics, group, shards)
        return params, new_state, opt_state, metrics

    return train_step


def train_step_from_config(network, cfg, steps_per_epoch: int, device='cuda',
                           observing: bool = True, bn_frozen: bool = False, group=None,
                           spatial=None):
    """(train_step, optimizer) as the config sets them, the way the JAX
    trainer builds its step: the lr schedule of ``build_schedule`` over
    ``steps_per_epoch``, ``train.weight_decay`` and ``train.grad_clip``,
    ``system.compute_dtype`` and device labels from ``cfg.model`` with their
    anchors on ``device``; then sparse-L1 of ``sparse.ratio`` on every
    prunable BN gamma when ``sparse.switch`` is on, ``train.remat``,
    ``train.head_probe`` and ``train.s2d_stem``; or, with ``quant.switch``,
    the QAT step of the phase ``observing``/``bn_frozen`` (of the quant
    graph's ``network``), which reads none of those four. Either step augments on the device
    with ``augment.device`` (its batches then carry their ``draws``). ``group``: the
    data-parallel step of this rank (the module docstring); None at world size 1.
    ``spatial``: this rank's ``SpatialCtx`` under ``train.spatial``."""
    t = cfg.train
    optimizer = make_optimizer(build_schedule(cfg, steps_per_epoch),
                               weight_decay=t.weight_decay, grad_clip=t.grad_clip)
    dtype = COMPUTE_DTYPES[cfg.system.compute_dtype]
    labels = label_assigner_from_config(cfg, device=device)
    augment = augmenter_from_config(cfg) if cfg.augment.device else None
    if cfg.quant.switch:
        return make_qat_train_step(network, optimizer, observing=observing,
                                   bn_frozen=bn_frozen, compute_dtype=dtype,
                                   label_fn=labels, augment_fn=augment, group=group,
                                   spatial=spatial), optimizer
    sparse = bool(cfg.sparse.switch)
    step = make_train_step(network, optimizer,
                           sparse_ratio=cfg.sparse.ratio if sparse else 0.0,
                           sparse_ids=sparse_bn_gamma_ids(network) if sparse else None,
                           compute_dtype=dtype, remat=int(t.remat),
                           probe_heads=bool(t.head_probe), label_fn=labels,
                           augment_fn=augment, s2d_stem=int(t.s2d_stem), group=group,
                           spatial=spatial)
    return step, optimizer


def _index(tree, k):
    if isinstance(tree, dict):
        return {key: _index(v, k) for key, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_index(v, k) for v in tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: _index(getattr(tree, f.name), k)
                                            for f in dataclasses.fields(tree)})
    return tree[k]


def stack_batches(batches: list):
    """K batches of one structure (dicts, tuples, tensors, dataclasses such
    as ``AugmentDraws``) as one, each tensor stacked on a new leading (K,
    ...) axis: ``make_multi_step``'s input."""
    first = batches[0]
    if isinstance(first, dict):
        return {key: stack_batches([b[key] for b in batches]) for key in first}
    if isinstance(first, (list, tuple)):
        return type(first)(stack_batches(list(vs)) for vs in zip(*batches))
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: stack_batches([getattr(b, f.name) for b in batches])
            for f in dataclasses.fields(first)})
    return torch.stack(batches)


def make_multi_step(train_step, unroll: int):
    """``unroll`` train steps as a plain loop (JAX scans them in one
    program; here each step is its own launches, so a group of K is K
    single steps in order). Batches arrive stacked with a leading (K, ...)
    axis (``stack_batches``), ``rngs`` is K generators (or None); metrics
    come back stacked."""
    def multi_step(params, state, opt_state, batches, rngs=None):
        out = []
        for k in range(unroll):
            params, state, opt_state, m = train_step(
                params, state, opt_state, _index(batches, k),
                None if rngs is None else rngs[k])
            out.append(m)
        metrics = {key: torch.stack([m[key] for m in out]) for key in out[0]}
        return params, state, opt_state, metrics

    return multi_step
