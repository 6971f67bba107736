"""The port's train step against ``jax.jit`` of the JAX package's
``make_train_step`` (CPU, f32): mobilenetv2-fpn at width_mult 0.25, 64x64,
B=2, device labels from padded GT, sparse-L1, a binding global-norm clip
and weight decay on, the lr of update k ``LR * (k + 1)`` (> 0 from the
first update). Weights: JAX ``net.init``, carried across by
``bridge.from_jax_params``. The optimizer alone is held to the optax
chain on the same grads to f32 rounding (``test_optimizer_matches_optax``).

Why the bounds of the train-mode step are loose: at init, a walk with
batch statistics in its BN layers amplifies a relative change of its
input ~1000-fold by the last layers (``test_train_walk_amplifies_rounding``
measures it), so the 1-ulp differences of two conv libraries reach the
loss at ~1e-4 and the grads at ~15 % of a leaf's largest element, and
Adam's first update, about lr * sign(g), moves the elements whose grad is
at that noise level the other way, which the next steps amplify again
(losses ~3 % apart after one update of lr 1e-3). JAX run on the same
batches with their images reversed (the same step, its sums in another
order) drifts as far from JAX, and the params are held to that yardstick.
The same walk with running statistics (``tests/test_torch_train_walk.py``)
agrees to 1e-6 on the loss and 1e-6 of the largest grad element; the
train-mode step of this net is held step by step at 128x128, B=4, where
its loss agrees to 1e-5 (``tests/test_torch_train_parity.py``); here the
whole step runs free at the size the JAX package's own step test uses.
Three steps are also held tightly on a shallow six-conv net, where the
conditioning is not in the way
(``test_three_steps_of_a_shallow_net_match_jax``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
from pqdet_tpu.ops.labels import assign_labels_device as jax_assign
from pqdet_tpu.ops.preprocess import device_normalize as jax_normalize
from pqdet_tpu.train.step import add_sparse_l1 as jax_add_sparse_l1
from pqdet_tpu.train.step import make_optimizer as jax_make_optimizer
from pqdet_tpu.train.step import make_train_step as jax_make_train_step
from pqdet_tpu.train.step import sparse_bn_gamma_ids as jax_sparse_ids
from pqdet_tpu.zoo.mobilenetv2 import mobilenetv2_fpn as jax_mobilenetv2_fpn
from pqdet_tpu_torch.bridge import from_jax_params
from pqdet_tpu_torch.config import Config
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.ops.labels import label_assigner_from_config
from pqdet_tpu_torch.ops.preprocess import device_normalize
from pqdet_tpu_torch.train.step import (add_sparse_l1, make_loss_fn, make_optimizer,
                                        make_train_step, sparse_bn_gamma_ids, tree_leaves,
                                        value_and_grad)
from pqdet_tpu_torch.zoo import CfgBuilder, get_cfg

SIZE, B, MAX_GT = 64, 2, 16
LR, WD, CLIP, SPARSE = 1e-3, 1e-3, 1e5, 0.01
ANCHORS = np.array(Config().model.anchors, np.float32)


def schedule(k):
    return LR * (k + 1)


def _batch(seed):
    rng = np.random.RandomState(seed)
    gt = np.zeros((B, MAX_GT, 6), np.float32)
    for i in range(B):
        n = rng.randint(3, MAX_GT + 1)
        cxy = rng.rand(n, 2) * (SIZE - 8) + 4
        wh = rng.rand(n, 2) * 40 + 4
        gt[i, :n] = np.concatenate([cxy - wh / 2, cxy + wh / 2, rng.randint(0, 20, (n, 1)),
                                    rng.rand(n, 1) * 0.5 + 0.5], 1)
    return {'image': rng.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8), 'gt': gt}


def _jax_label_fn(gt, size):
    return jax_assign(gt, size, [8, 16, 32], ANCHORS, 20)


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.fixture(scope='module')
def model():
    jnet = JaxNetwork.from_cfg(jax_mobilenetv2_fpn(width_mult=0.25))
    params, state = jnet.init(jax.random.PRNGKey(0))
    net = DetectionNetwork.from_cfg(get_cfg('mobilenetv2-fpn', width_mult=0.25))
    tp, ts = from_jax_params(params, state, net.graph, device='cpu')
    return jnet, params, state, net, tp, ts


def _reversed(b):
    """The batch with its images in reverse order: the same step, with its
    sums taken in another order."""
    return {k: v[::-1].copy() for k, v in b.items()}


@pytest.fixture(scope='module')
def jax_run(model):
    """Three jitted JAX steps from the same start, one batch each; and the
    same three steps on the reversed batches, JAX's own rounding yardstick."""
    jnet, params, state, *_ = model
    opt = jax_make_optimizer(schedule, weight_decay=WD, grad_clip=CLIP)
    step = jax.jit(jax_make_train_step(jnet, opt, sparse_ratio=SPARSE,
                                       sparse_ids=jax_sparse_ids(jnet),
                                       label_fn=_jax_label_fn))
    runs = {}
    for name, order in (('jax', lambda b: b), ('reversed', _reversed)):
        p, s, o = params, state, opt.init(params)
        out = []
        for k in range(3):
            p, s, o, m = step(p, s, o, jax.tree.map(jnp.asarray, order(_batch(k))),
                              jax.random.PRNGKey(k))
            out.append((jax.device_get(p), jax.device_get(s), jax.device_get(m)))
        runs[name] = out
    return runs


def _port_steps(model, n):
    *_, net, tp, ts = model
    opt = make_optimizer(schedule, weight_decay=WD, grad_clip=CLIP)
    step = make_train_step(net, opt, sparse_ratio=SPARSE, sparse_ids=sparse_bn_gamma_ids(net),
                           label_fn=label_assigner_from_config(Config(), device='cpu'))
    p, s, o = tp, ts, opt.init(tp)
    out = []
    for k in range(n):
        p, s, o, m = step(p, s, o, _torch_batch(_batch(k)))
        out.append((p, s, m))
    assert o['count'] == n
    return out


def _flat(tree):
    return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])


@pytest.mark.parametrize('n_steps', [1, 3])
def test_train_step_matches_jax(model, jax_run, n_steps):
    """After 1 and after 3 steps. Bounds (f32, see the module docstring):
    the loss and its parts of the first step rtol 1e-3, of the later steps
    5e-2; the BN running statistics |d| <= 1e-2 * max(1, |s|) after one
    step, 2e-1 after three (two updates have moved the batch statistics of
    the deepest layers by tens of %); the params: their L2 distance from
    JAX's at most 2x that of JAX's own run on the reversed batches (measured
    0.96x after one step, 1.03x after three), and of
    the elements JAX moved by over half an lr, at least 90 % moved the same
    way by the port after one step (the rest have grads at the level of the
    conditioning's noise), 70 % after three (78 % measured)."""
    jnet, params, state, net, tp, ts = model
    ours = _port_steps(model, n_steps)
    for k in range(n_steps):
        jm, tm = jax_run['jax'][k][2], ours[k][2]
        rtol = 1e-3 if k == 0 else 5e-2
        for name in ('loss', 'giou_loss', 'conf_loss', 'class_loss'):
            np.testing.assert_allclose(float(tm[name]), float(jm[name]), rtol=rtol,
                                       err_msg=f'step {k} {name}')
        np.testing.assert_allclose(tm['loss_per_branch'].numpy(), jm['loss_per_branch'],
                                   rtol=rtol)
    jp, js, _ = jax_run['jax'][n_steps - 1]
    tp_n, ts_n, _ = ours[-1]
    want_p, want_s = from_jax_params(jp, js, net.graph, device='cpu')
    own_p, _ = from_jax_params(jax_run['reversed'][n_steps - 1][0], js, net.graph, device='cpu')
    assert sorted(ts_n) == sorted(want_s)
    for key in want_s:
        for st in ('mean', 'var'):
            a, b = ts_n[key][st], want_s[key][st]
            bound = (1e-2 if n_steps == 1 else 2e-1) * b.abs().clamp_min(1.0).max()
            assert (a - b).abs().max() <= bound, (key, st)
    got, want, start = _flat(tp_n), _flat(want_p), _flat(tp)
    gap, own = (got - want).norm().item(), (_flat(own_p) - want).norm().item()
    first = {who: abs(float(run[0][2]['loss']) / float(jax_run['jax'][0][2]['loss']) - 1)
             for who, run in (('port', ours), ('reversed', jax_run['reversed']))}
    print(f'{n_steps} steps: params L2 distance from JAX {gap:.4g}, JAX on the reversed '
          f'batches {own:.4g}; first loss rel gap {first["port"]:.3g}, JAX on the reversed '
          f'batch {first["reversed"]:.3g}')
    assert gap <= 2 * own
    moved = (want - start).abs() > 0.5 * LR
    same = torch.sign(got - start)[moved] == torch.sign(want - start)[moved]
    assert moved.float().mean() > 0.5 and same.float().mean() >= (0.9 if n_steps == 1 else 0.7), \
        (moved.float().mean().item(), same.float().mean().item())


def test_train_step_grads_match_jax(model):
    """Per-leaf grads of the train-mode loss, JAX's jax.value_and_grad
    against the port's autograd: the whole grad vector within a relative
    L2 distance of 0.5, and each leaf whose norm is over 1e-3 of the
    largest leaf's at a cosine of 0.9 or more (see the module docstring
    for why not closer); the loss rtol 1e-3."""
    jnet, params, state, net, tp, ts = model
    b = _batch(0)

    def jloss(p, s, batch):
        image = jax_normalize(batch['image'])
        targets = _jax_label_fn(batch['gt'], image.shape[1:3])
        losses, _ = jnet.apply(p, s, image, targets=targets, train=True)
        return losses['loss'][0]
    jl, jg = jax.jit(jax.value_and_grad(jloss))(params, state, jax.tree.map(jnp.asarray, b))
    loss_fn = make_loss_fn(net, label_fn=label_assigner_from_config(Config(), device='cpu'))
    (tl, _), tg = value_and_grad(loss_fn, tp, ts, _torch_batch(b))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-3)
    want, _ = from_jax_params(jg, state, net.graph, device='cpu')
    got_l, want_l = tree_leaves(tg), tree_leaves(want)
    assert [t.shape for t in got_l] == [t.shape for t in want_l]
    g, w = torch.cat([t.reshape(-1) for t in got_l]), torch.cat([t.reshape(-1) for t in want_l])
    assert ((g - w).norm() / w.norm()).item() <= 0.5
    top = max(t.norm().item() for t in want_l)
    for a, b_ in zip(got_l, want_l):
        if b_.norm() > 1e-3 * top:
            cos = (a * b_).sum() / (a.norm() * b_.norm())
            assert cos >= 0.9, cos.item()


def test_train_walk_amplifies_rounding(model):
    """The conditioning behind the bounds above: a 1e-6 relative change of
    the input moves the last head conv's output of the train-mode walk by
    over 1e-4 of its largest value (and the eval-mode walk's by far less)."""
    *_, net, tp, ts = model
    x = device_normalize(_torch_batch(_batch(0))['image'])
    outs = {}
    for train in (True, False):
        for k, xx in enumerate((x, x * (1 + 1e-6))):
            got = {}
            with torch.no_grad():
                net.forward_train(tp, ts, xx, train=train,
                                  tap=lambda i, t: got.__setitem__(i, t))
            outs[train, k] = got[len(net.graph.nodes) - 2]
    rel = {t: ((outs[t, 0] - outs[t, 1]).abs().max() / outs[t, 0].abs().max()).item()
           for t in (True, False)}
    assert rel[True] > 1e-4 and rel[True] > 30 * rel[False], rel


def _tree(rng, scale):
    return {'0': {'w': (rng.randn(8, 3, 3, 3) * scale).astype(np.float32),
                  'bn': {'gamma': (rng.randn(8) * scale).astype(np.float32),
                         'beta': (rng.randn(8) * scale).astype(np.float32)}},
            '1': {'w': (rng.randn(4, 8, 1, 1) * scale).astype(np.float32),
                  'b': (rng.randn(4) * scale).astype(np.float32)}}


def _leaves_like(like, tree):
    """The leaves of ``tree`` in the order of ``tree_leaves(like)``."""
    return [x for k, v in like.items()
            for x in (_leaves_like(v, tree[k]) if isinstance(v, dict) else [np.asarray(tree[k])])]


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


@pytest.mark.parametrize('clip', [0.0, 0.5, 1e6])
def test_optimizer_matches_optax(clip):
    """Three updates of the port's Adam and of JAX's make_optimizer (optax)
    on the same params and grads, with weight decay and the lr of update k
    ``schedule(k)``: params equal within rtol 1e-6, atol 1e-6 of the lr (f32
    on both sides). clip 0.5 binds, 1e6 does not, 0 is off. Grads near 0
    (down to 1e-9) and exactly 0 are included: Adam's eps decides there."""
    rng = np.random.RandomState(5)
    params = _tree(rng, 0.5)
    jopt = jax_make_optimizer(schedule, weight_decay=WD, grad_clip=clip)
    topt = make_optimizer(schedule, weight_decay=WD, grad_clip=clip)
    jp, js = jax.tree.map(jnp.asarray, params), None
    js = jopt.init(jp)
    tp = _to_torch(params)
    ts = topt.init(tp)
    for k in range(3):
        grads = _tree(rng, 1.0)
        grads['0']['w'][0] *= 1e-9
        grads['1']['b'][:2] = 0.0
        upd, js = jopt.update(jax.tree.map(jnp.asarray, grads), js, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, upd)
        tp, ts = topt.update(_to_torch(grads), ts, tp)
        assert ts['count'] == k + 1
        for a, b in zip(tree_leaves(tp), _leaves_like(tp, jp)):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-6,
                                       atol=1e-6 * schedule(k), err_msg=f'update {k}')


def test_add_sparse_l1_matches_jax():
    rng = np.random.RandomState(6)
    params, grads = _tree(rng, 1.0), _tree(rng, 1.0)
    params['0']['bn']['gamma'][:2] = 0.0            # sign(0) = 0
    ref = jax_add_sparse_l1(jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, params),
                            {'0'}, 0.01)
    out = add_sparse_l1(_to_torch(grads), _to_torch(params), {'0'}, 0.01)
    for a, b in zip(tree_leaves(out), _leaves_like(out, ref)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-7)
    assert not np.array_equal(out['0']['bn']['gamma'].numpy(), grads['0']['bn']['gamma'])


def test_sparse_ids_match_jax(model):
    jnet, *_, net, _, _ = model
    assert sparse_bn_gamma_ids(net) == jax_sparse_ids(jnet) != set()


def _shallow_cfg():
    """Six convs (five with BN) and three heads at strides 8, 16 and 32."""
    b = CfgBuilder()
    b.conv(8, size=3, stride=2)
    b.conv(16, size=3, stride=2)
    t8 = b.conv(16, size=3, stride=2)
    t16 = b.conv(24, size=3, stride=2)
    b.conv(32, size=3, stride=2)
    b.conv(75, size=1, bn=False, activation='linear')
    b.yolo(20)
    b.route(t16)
    b.conv(75, size=1, bn=False, activation='linear')
    b.yolo(20)
    b.route(t8)
    b.conv(75, size=1, bn=False, activation='linear')
    b.yolo(20)
    return b.text()


def test_three_steps_of_a_shallow_net_match_jax():
    """Three jitted JAX steps against three of the port's on a shallow net
    (sparse-L1, binding clip, weight decay, lr of update k LR * (k + 1)):
    the losses and parts of each step rtol 1e-5, the BN state rtol 1e-5,
    atol 1e-5; the params within 1e-2 of an lr of JAX's, except elements
    whose first update JAX made under 0.999 lr: their effective grad (after
    clip and L2, often two near-equal terms) is under ~1e-5, where Adam's
    eps sets the update and rounding its sign. They are reported and may
    differ by up to 2 lrs a step."""
    text = _shallow_cfg()
    jnet = JaxNetwork.from_cfg(text)
    params, state = jnet.init(jax.random.PRNGKey(1))
    net = DetectionNetwork.from_cfg(text)
    tp, ts = from_jax_params(params, state, net.graph, device='cpu')
    jopt = jax_make_optimizer(schedule, weight_decay=WD, grad_clip=1.0)
    jstep = jax.jit(jax_make_train_step(jnet, jopt, sparse_ratio=SPARSE,
                                        sparse_ids=jax_sparse_ids(jnet),
                                        label_fn=_jax_label_fn))
    opt = make_optimizer(schedule, weight_decay=WD, grad_clip=1.0)
    step = make_train_step(net, opt, sparse_ratio=SPARSE, sparse_ids=sparse_bn_gamma_ids(net),
                           label_fn=label_assigner_from_config(Config(), device='cpu'))
    jp, js, jo = params, state, jopt.init(params)
    p, s, o = tp, ts, opt.init(tp)
    start = _flat(tp)
    for k in range(3):
        b = _batch(k)
        jp, js, jo, jm = jstep(jp, js, jo, jax.tree.map(jnp.asarray, b), jax.random.PRNGKey(k))
        p, s, o, m = step(p, s, o, _torch_batch(b))
        for name in ('loss', 'giou_loss', 'conf_loss', 'class_loss'):
            np.testing.assert_allclose(float(m[name]), float(jm[name]), rtol=1e-5,
                                       err_msg=f'step {k} {name}')
        want_p, want_s = from_jax_params(jax.device_get(jp), jax.device_get(js), net.graph,
                                         device='cpu')
        for key in want_s:
            for st in ('mean', 'var'):
                np.testing.assert_allclose(s[key][st].numpy(), want_s[key][st].numpy(),
                                           rtol=1e-5, atol=1e-5)
        if k == 0:
            small = (_flat(want_p) - start).abs() < 0.999 * schedule(0)
        d = (_flat(p) - _flat(want_p)).abs()
        lr_sum = sum(schedule(j) for j in range(k + 1))
        assert d[~small].max() <= 1e-2 * LR, (k, d[~small].max().item())
        assert not small.any() or d[small].max() <= 2 * lr_sum * 1.01
    print(f'{int(small.sum())} of {small.numel()} params took a first update under '
          '0.999 lr')
