"""The port's train step held to ``jax.jit`` of the JAX package's
``make_train_step`` step by step on the real net (CPU, f32):
mobilenetv2-fpn at width_mult 0.25, 128x128, B=4, device labels, sparse-L1,
a binding global-norm clip and weight decay on, the lr of update k
``LR * (k + 1)``.

Each of three steps starts both sides from JAX's params, BN state and Adam
state after the steps before it (the port's taken across with
``bridge.from_jax_params``), so step 3 runs with two updates' moments and
count behind it, and a rounding difference of one step does not steer the
next. At this size the loss of each step agrees with JAX's to 1e-5.

The rest is held against a yardstick of JAX's own: the same JAX step on the
batch with its images in reverse order, which is the same function with its
sums taken in another order. A walk with batch statistics amplifies the
rounding of its first layers ~1000-fold by its last
(``tests/test_torch_train_step.py::test_train_walk_amplifies_rounding``),
so JAX against itself moves a few % of the grad vector and flips the sign
of the first update of ~1 % of the params. The port must stay within a
small multiple of that: a wrong term in any leaf, a wrong moment or a
wrong update shows as far more.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
import torch

from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
from pqdet_tpu.ops.labels import assign_labels_device as jax_assign
from pqdet_tpu.train.step import make_optimizer as jax_make_optimizer
from pqdet_tpu.train.step import make_train_step as jax_make_train_step
from pqdet_tpu.train.step import sparse_bn_gamma_ids as jax_sparse_ids
from pqdet_tpu.zoo.mobilenetv2 import mobilenetv2_fpn as jax_mobilenetv2_fpn
from pqdet_tpu_torch.bridge import from_jax_params
from pqdet_tpu_torch.config import Config
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.ops.labels import label_assigner_from_config
from pqdet_tpu_torch.train.step import (make_optimizer, make_train_step, sparse_bn_gamma_ids,
                                        tree_leaves)
from pqdet_tpu_torch.zoo import get_cfg

SIZE, B, MAX_GT, STEPS = 128, 4, 16, 3
LR, WD, CLIP, SPARSE = 1e-3, 1e-3, 1.0, 0.01
ANCHORS = np.array(Config().model.anchors, np.float32)
PARTS = ('loss', 'giou_loss', 'conf_loss', 'class_loss')


def schedule(k):
    return LR * (k + 1)


def _batch(seed):
    """B seeded images and 3 to MAX_GT boxes each, 4 px to 0.6 of the image
    a side."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((B, MAX_GT, 6), np.float32)
    for i in range(B):
        n = rng.randint(3, MAX_GT + 1)
        cxy = rng.rand(n, 2) * (SIZE - 8) + 4
        wh = rng.rand(n, 2) * (0.6 * SIZE) + 4
        gt[i, :n] = np.concatenate([cxy - wh / 2, cxy + wh / 2, rng.randint(0, 20, (n, 1)),
                                    rng.rand(n, 1) * 0.5 + 0.5], 1)
    return {'image': rng.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8), 'gt': gt}


def _flat(tree):
    return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])


def _adam(opt_state):
    """The Adam moments of the JAX optimizer's state (flat, as
    ``optax.flatten`` keeps them)."""
    has_mu = lambda s: hasattr(s, 'mu')  # noqa: E731
    return next(s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=has_mu) if has_mu(s))


@pytest.fixture(scope='module')
def run():
    """Per step k: JAX's step on batch k and on batch k reversed, and the
    port's on batch k, all three from JAX's state after steps 0..k-1.
    Effective grads (after sparse-L1, clip and L2) are read off each
    side's new first moment, ``(mu - 0.9 mu_before) / 0.1``."""
    jnet = JaxNetwork.from_cfg(jax_mobilenetv2_fpn(width_mult=0.25))
    params, state = jnet.init(jax.random.PRNGKey(0))
    net = DetectionNetwork.from_cfg(get_cfg('mobilenetv2-fpn', width_mult=0.25))
    unravel = ravel_pytree(params)[1]

    def port_flat(v, js):
        """A flat vector in JAX's order -> the port's order and layout."""
        return _flat(from_jax_params(jax.device_get(unravel(v)), js, net.graph, device='cpu')[0])

    jopt = jax_make_optimizer(schedule, weight_decay=WD, grad_clip=CLIP)
    jstep = jax.jit(jax_make_train_step(
        jnet, jopt, sparse_ratio=SPARSE, sparse_ids=jax_sparse_ids(jnet),
        label_fn=lambda gt, size: jax_assign(gt, size, [8, 16, 32], ANCHORS, 20)))
    opt = make_optimizer(schedule, weight_decay=WD, grad_clip=CLIP)
    step = make_train_step(net, opt, sparse_ratio=SPARSE, sparse_ids=sparse_bn_gamma_ids(net),
                           label_fn=label_assigner_from_config(Config(), device='cpu'))
    jp, js, jo = params, state, jopt.init(params)
    out = []
    for k in range(STEPS):
        b = _batch(k)
        js_host = jax.device_get(js)
        p0, s0 = from_jax_params(jax.device_get(jp), js_host, net.graph, device='cpu')
        mu0 = port_flat(_adam(jo).mu, js_host)
        o0 = {'count': k, 'schedule_count': k, 'mu': mu0,
              'nu': port_flat(_adam(jo).nu, js_host)}
        res = {}
        for name, bb in (('jax', b), ('reversed', {key: v[::-1].copy() for key, v in b.items()})):
            np_, ns, no, m = jstep(jp, js, jo, jax.tree.map(jnp.asarray, bb),
                                   jax.random.PRNGKey(k))
            wp, ws = from_jax_params(jax.device_get(np_), jax.device_get(ns), net.graph,
                                     device='cpu')
            grad = (port_flat(_adam(no).mu, js_host) - 0.9 * mu0) / 0.1
            res[name] = {'loss': {n: float(m[n]) for n in PARTS}, 'state': ws,
                         'params': _flat(wp), 'grad': grad}
            if name == 'jax':
                nxt = (np_, ns, no)
        p, s, o, m = step(p0, s0, o0, {key: torch.from_numpy(v) for key, v in b.items()})
        assert o['count'] == k + 1
        res['port'] = {'loss': {n: float(m[n]) for n in PARTS}, 'state': s, 'params': _flat(p),
                       'grad': (o['mu'] - 0.9 * mu0) / 0.1}
        res['start'] = _flat(p0)
        out.append(res)
        jp, js, jo = nxt
    return out, [t.numel() for t in tree_leaves(p0)]


def _gap(res, who, what):
    """|who - JAX| / |JAX| of a flat vector, as an L2 ratio."""
    a, w = res[who][what], res['jax'][what]
    return ((a - w).norm() / w.norm()).item()


@pytest.mark.parametrize('k', range(STEPS))
def test_loss_matches_jax(run, k):
    """The loss of step k+1 within rtol 1e-5 of JAX's (measured 5e-6, 8e-6,
    2e-6); each part within rtol 1e-5 or 3x JAX's own gap on the reversed
    batch, whichever is larger (the giou part differs by 3e-5 between the
    two orders of JAX's own sums)."""
    res = run[0][k]
    want = res['jax']['loss']
    np.testing.assert_allclose(res['port']['loss']['loss'], want['loss'], rtol=1e-5)
    for n in PARTS[1:]:
        own = abs(res['reversed']['loss'][n] / want[n] - 1)
        assert abs(res['port']['loss'][n] / want[n] - 1) <= max(1e-5, 3 * own), n


@pytest.mark.parametrize('k', range(STEPS))
def test_bn_state_matches_jax(run, k):
    """The BN running statistics after step k+1: |d| <= 1e-5 * max(1, |s|)
    per element (measured 2e-6)."""
    res = run[0][k]
    got, want = res['port']['state'], res['jax']['state']
    assert sorted(got) == sorted(want)
    for key in want:
        for st in ('mean', 'var'):
            a, w = got[key][st], want[key][st]
            assert ((a - w).abs() <= 1e-5 * w.abs().clamp_min(1.0)).all(), (key, st)


@pytest.mark.parametrize('k', range(STEPS))
def test_grads_match_jax(run, k):
    """The effective grads of step k+1 (after sparse-L1, clip and L2): the
    whole vector's L2 distance from JAX's at most 2x JAX's own on the
    reversed batch (measured 1.5x, 0.7x, 0.8x), and each leaf's at most 5x
    its own plus 1e-4 (measured up to 3.8x: one leaf's gap is one sample of
    the rounding)."""
    (res, sizes) = run[0][k], run[1]
    assert _gap(res, 'port', 'grad') <= 2 * _gap(res, 'reversed', 'grad')
    leaves = {who: torch.split(res[who]['grad'], sizes) for who in ('port', 'reversed', 'jax')}
    for i, w in enumerate(leaves['jax']):
        port = ((leaves['port'][i] - w).norm() / w.norm()).item()
        own = ((leaves['reversed'][i] - w).norm() / w.norm()).item()
        assert port <= 5 * own + 1e-4, (i, port, own)


@pytest.mark.parametrize('k', range(STEPS))
def test_params_match_jax(run, k):
    """The params after update k (lr ``schedule(k)``): the update's L2
    distance from JAX's at most 2x JAX's own on the reversed batch, and the
    elements more than 1e-2 lr from JAX's no more than 2x as many as JAX's
    own (measured 5339 against 4339 after the first update, then 74418
    against 102602 and 117133 against 142971; an element is up to 2 lr off
    where Adam's first, sign-like update went the other way)."""
    res = run[0][k]
    lr = schedule(k)
    want = res['jax']['params']
    upd = want - res['start']
    gaps = {who: (res[who]['params'] - want) for who in ('port', 'reversed')}
    assert gaps['port'].norm() <= 2 * gaps['reversed'].norm() + 1e-6 * upd.norm()
    far = {who: int((g.abs() > 1e-2 * lr).sum()) for who, g in gaps.items()}
    assert far['port'] <= 2 * far['reversed'], far
    print(f'update {k}: {far["port"]} of {want.numel()} params over 1e-2 lr from JAX\'s '
          f'({far["reversed"]} for JAX on the reversed batch)')
