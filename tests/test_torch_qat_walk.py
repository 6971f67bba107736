"""The QAT training walk of the port (``make_qat_loss_fn``: fake-quant
input, per-channel weight fake-quant under autograd, an observer on every
quantised edge) against ``jax.value_and_grad`` of the JAX trainer's QAT
loss (``Trainer._wrap_quant_step``), on the quant graph of mobilenetv2-fpn
at width 0.25, 64x64, B=2, device labels. Both sides start from JAX's
weights with seeded BN statistics and observers that one JAX observer pass
initialised, carried across with ``bridge.from_jax_params``.

Two phases of the trainer's schedule in f32: the last one (BN frozen on
its running statistics, observers frozen), well conditioned and held
tightly, and the first (batch statistics, observers updating). The walk
with batch statistics amplifies rounding (tests/test_torch_train_parity.py)
and the fake-quant adds to that: a rounding difference can move an
activation across a code boundary, a whole quantisation step. So its grads
are also held to JAX's own drift, the same JAX function on the batch with
its images reversed (the observers' min and max do not depend on the
order), which here moves the grads by more than their norm. The bf16 walk
is the one the trainer runs: both packages fake-quantise each edge in f32
and carry bf16 between nodes; two bf16 walks round at other places, so it
is held to a stated tolerance.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pqdet_tpu.compress.qat import QuantCtx as JaxQuantCtx
from pqdet_tpu.compress.qat import prepare_qat_state as jax_prepare_qat_state
from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
from pqdet_tpu.ops.labels import assign_labels_device as jax_assign
from pqdet_tpu.ops.preprocess import device_normalize as jax_normalize
from pqdet_tpu.zoo.mobilenetv2 import mobilenetv2_fpn as jax_mobilenetv2_fpn
from pqdet_tpu_torch.bridge import from_jax_params
from pqdet_tpu_torch.config import Config
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.ops.labels import label_assigner_from_config
from pqdet_tpu_torch.train.step import make_qat_loss_fn, tree_leaves, value_and_grad
from pqdet_tpu_torch.zoo import get_cfg

SIZE, B, MAX_GT = 64, 2, 8
ANCHORS = np.array(Config().model.anchors, np.float32)
PARTS = ('loss', 'giou_loss', 'conf_loss', 'class_loss')


def _batch(seed):
    rng = np.random.RandomState(seed)
    gt = np.zeros((B, MAX_GT, 6), np.float32)
    for i in range(B):
        n = rng.randint(2, MAX_GT + 1)
        cxy = rng.rand(n, 2) * (SIZE - 8) + 4
        wh = rng.rand(n, 2) * (0.6 * SIZE) + 4
        gt[i, :n] = np.concatenate([cxy - wh / 2, cxy + wh / 2, rng.randint(0, 20, (n, 1)),
                                    rng.rand(n, 1) * 0.5 + 0.5], 1)
    return {'image': rng.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8), 'gt': gt}


def _model():
    jnet = JaxNetwork.from_cfg(jax_mobilenetv2_fpn(width_mult=0.25), quant=True)
    params, state = jnet.init(jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    for k in state:
        c = np.asarray(state[k]['mean']).shape[0]
        state[k] = {'mean': jnp.asarray(rng.randn(c).astype(np.float32) * 0.1),
                    'var': jnp.asarray(rng.rand(c).astype(np.float32) * 0.4 + 0.8)}
    params, state = jax_prepare_qat_state(jnet, params, state)

    @jax.jit
    def observer_pass(params, state, x):
        ctx = JaxQuantCtx(state['quant'], observing=True)
        jnet.apply(params, state, x, train=True, quant_ctx=ctx)
        return ctx.new_obs

    # observers initialised by one pass with batch statistics, the ranges
    # the first QAT epoch sees
    state = {**state, 'quant': observer_pass(params, state,
                                             jax_normalize(jnp.asarray(_batch(9)['image'])))}
    params, state = jax.device_get((params, state))
    net = DetectionNetwork.from_cfg(get_cfg('mobilenetv2-fpn', width_mult=0.25), quant=True)
    return jnet, params, state, net


@pytest.fixture(scope='module')
def model():
    return _model()


def _jax_loss_fn(jnet, train, observing, compute_dtype):
    """The loss of the JAX trainer's QAT step (``_wrap_quant_step``)."""
    def loss_fn(p, state, batch):
        ctx = JaxQuantCtx(state['quant'], observing=observing)
        image = jax_normalize(batch['image'])
        targets = jax_assign(batch['gt'], image.shape[1:3], [8, 16, 32], ANCHORS, 20)
        losses, new_state = jnet.apply(p, state, image, targets=targets, train=train,
                                       compute_dtype=compute_dtype, quant_ctx=ctx)
        new_state['quant'] = ctx.new_obs
        return losses['loss'][0], (losses, new_state)
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def _run(model, train, observing, dtype, reversed_too=False):
    """{'jax', 'port'} (and 'reversed'): loss parts, grads (the port's
    layout, per leaf) and new state (BN statistics and observers), on batch
    0."""
    jnet, params, state, net = model
    jdtype = {None: None, torch.bfloat16: jnp.bfloat16}[dtype]
    jfn = _jax_loss_fn(jnet, train, observing, jdtype)
    b = _batch(0)
    out = {}
    runs = [('jax', b)]
    if reversed_too:
        runs.append(('reversed', {k: v[::-1].copy() for k, v in b.items()}))
    for name, bb in runs:
        (_, (losses, ns)), g = jfn(params, state, jax.tree.map(jnp.asarray, bb))
        gp, gs = from_jax_params(jax.device_get(g), jax.device_get(ns), net.graph,
                                 device='cpu')
        out[name] = {'parts': np.array([float(losses[k][0]) for k in PARTS]),
                     'grads': tree_leaves(gp), 'state': gs}
    tp, ts = from_jax_params(params, state, net.graph, device='cpu')
    loss_fn = make_qat_loss_fn(net, observing=observing, bn_frozen=not train,
                               compute_dtype=dtype,
                               label_fn=label_assigner_from_config(Config(), device='cpu'))
    (_, (losses, ns, _)), g = value_and_grad(
        loss_fn, tp, ts, {k: torch.from_numpy(v) for k, v in b.items()})
    out['port'] = {'parts': np.array([float(losses[k][0]) for k in PARTS]),
                   'grads': tree_leaves(g), 'state': ns, 'start': ts}
    return out


def _flat(leaves):
    return torch.cat([t.reshape(-1) for t in leaves])


def _assert_grads_close(got, want, rtol, atol_top):
    """|d| <= rtol |g| + atol_top * (the largest |g|) per element."""
    top = max(w.abs().max().item() for w in want)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        assert ((a - w).abs() <= rtol * w.abs() + atol_top * top).all()


def _assert_observers(got, want, tol):
    """min and max within tol * max(1, |v|) of JAX's, the same flags."""
    assert sorted(got) == sorted(want) and len(want) > 50
    for edge, o in want.items():
        for k in ('min', 'max'):
            assert abs(float(got[edge][k]) - float(o[k])) <= tol * max(1.0, abs(float(o[k]))), \
                (edge, k)
        assert bool(got[edge]['initialized']) == bool(o['initialized'])


def _assert_bn_state(got, want, tol):
    for key in want:
        if key != 'quant':
            for st in ('mean', 'var'):
                a, w = got[key][st], want[key][st]
                assert ((a - w).abs() <= tol * w.abs().clamp_min(1.0)).all(), (key, st)


def test_frozen_phase_matches_jax(model):
    """BN and observers frozen (the schedule's last phase), f32: loss and
    parts rtol 1e-5, grads 1e-4 of each element plus 1e-5 of the largest
    (measured 4e-7 and 7e-7 of the largest); the observers come back
    unchanged, bit for bit, and so do the BN statistics."""
    r = _run(model, train=False, observing=False, dtype=None)
    np.testing.assert_allclose(r['port']['parts'], r['jax']['parts'], rtol=1e-5)
    _assert_grads_close(r['port']['grads'], r['jax']['grads'], 1e-4, 1e-5)
    new, start = r['port']['state'], r['port']['start']
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(new), tree_leaves(start)))


def test_observing_phase_with_batch_statistics_matches_jax(model):
    """Observers updating and BN on batch statistics (the first phase),
    f32: loss rtol 1e-5 (measured 2e-7), each part within 1e-5 or 3x JAX's
    own gap on the reversed batch; the new observers and BN statistics
    within 1e-6 and 1e-5 of max(1, |v|) of JAX's (measured 1e-7); the grads'
    L2 distance from JAX's at most 2x JAX's own (measured 4.5e-6 against
    1.33: the reversed batch moves JAX's fake-quant codes) and each
    element within 1e-4 |g| + 1e-4 of the largest (measured 4.3e-6)."""
    r = _run(model, train=True, observing=True, dtype=None, reversed_too=True)
    j, p, v = r['jax'], r['port'], r['reversed']
    np.testing.assert_allclose(p['parts'][0], j['parts'][0], rtol=1e-5)
    own = np.abs(v['parts'] / j['parts'] - 1)
    assert (np.abs(p['parts'] / j['parts'] - 1) <= np.maximum(1e-5, 3 * own)).all()
    _assert_observers(p['state']['quant'], j['state']['quant'], 1e-6)
    _assert_bn_state(p['state'], j['state'], 1e-5)
    gj, gp, gv = _flat(j['grads']), _flat(p['grads']), _flat(v['grads'])
    assert (gp - gj).norm() <= 2 * (gv - gj).norm()
    _assert_grads_close(p['grads'], j['grads'], 1e-4, 1e-4)


def test_bf16_walk_matches_jax(model):
    """The trainer's walk, bf16 compute, observers updating and BN on
    batch statistics: loss rtol 5e-2 and parts 1e-1, the bounds of the fp
    bf16 step (tests/test_torch_train_walk.py; measured 2.4e-2 and 2.8e-2),
    the new observers within 2e-2 of max(1, |v|) (measured 3.2e-3): two bf16
    walks round at other places, and a rounding moves a code. Each edge
    fake-quantises in f32 on both sides (tests/test_torch_qat.py holds the
    edge itself exactly)."""
    r = _run(model, train=True, observing=True, dtype=torch.bfloat16)
    j, p = r['jax'], r['port']
    np.testing.assert_allclose(p['parts'][0], j['parts'][0], rtol=5e-2)
    np.testing.assert_allclose(p['parts'], j['parts'], rtol=1e-1)
    _assert_observers(p['state']['quant'], j['state']['quant'], 2e-2)
    assert all(t.dtype == torch.float32 and bool(torch.isfinite(t).all())
               for t in p['grads'])
