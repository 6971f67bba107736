"""The training walk of the port against the JAX package (CPU): the loss
and per-leaf grads with running BN statistics, where the walk is well
conditioned and the port is held tightly; one bf16 train step; and the
port's own invariants: remat segments give the plain walk's results,
dropout draws replay under remat, the multi-step loop equals single steps,
and the options that do not combine raise."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pqdet_tpu.ops.preprocess import device_normalize as jax_normalize
from pqdet_tpu.train.step import make_optimizer as jax_make_optimizer
from pqdet_tpu.train.step import make_train_step as jax_make_train_step
from pqdet_tpu_torch.bridge import from_jax_params
from pqdet_tpu_torch.config import Config
from pqdet_tpu_torch.model import network as network_module
from pqdet_tpu_torch.model.network import DetectionNetwork, to_device
from pqdet_tpu_torch.ops.labels import label_assigner_from_config
from pqdet_tpu_torch.ops.preprocess import device_normalize
from pqdet_tpu_torch.train.schedule import cosine_warmup, step_decay_warmup
from pqdet_tpu_torch.train.step import (make_loss_fn, make_multi_step, make_optimizer,
                                        make_train_step, sparse_bn_gamma_ids,
                                        train_step_from_config, tree_leaves, value_and_grad)
from pqdet_tpu_torch.zoo import CfgBuilder, get_cfg
from test_torch_train_step import (JaxNetwork, _batch, _jax_label_fn, _shallow_cfg,
                                   _torch_batch, jax_mobilenetv2_fpn, schedule)

LABELS = label_assigner_from_config(Config(), device='cpu')


def _models(which, seed=0):
    if which == 'shallow':
        jnet = JaxNetwork.from_cfg(_shallow_cfg())
        net = DetectionNetwork.from_cfg(_shallow_cfg())
    else:
        jnet = JaxNetwork.from_cfg(jax_mobilenetv2_fpn(width_mult=0.25))
        net = DetectionNetwork.from_cfg(get_cfg('mobilenetv2-fpn', width_mult=0.25))
    params, state = jnet.init(jax.random.PRNGKey(seed))
    tp, ts = from_jax_params(params, state, net.graph, device='cpu')
    return jnet, params, state, net, tp, ts


def test_loss_and_grads_with_running_bn_match_jax():
    """mobilenetv2-fpn (width 0.25, 64x64, B=2, f32), the YOLO loss with BN
    on its running statistics (``targets`` without ``train``): the loss and
    its parts rtol 1e-5; every grad element within 1e-4 of its own size
    plus 1e-5 of the largest grad element."""
    jnet, params, state, net, tp, ts = _models('mobilenetv2')
    b = _batch(0)

    def jloss(p, s, batch):
        image = jax_normalize(batch['image'])
        losses, _ = jnet.apply(p, s, image, targets=_jax_label_fn(batch['gt'], image.shape[1:3]))
        return losses['loss'][0], losses
    (jl, jlosses), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        params, state, jax.tree.map(jnp.asarray, b))

    def loss_fn(p, s, batch, rng=None):
        image = device_normalize(batch['image'])
        losses, new_state = net.forward_train(p, s, image, train=False,
                                              targets=LABELS(batch['gt'], image.shape[1:3]))
        assert all(new_state[k] is s[k] for k in s)
        return losses['loss'][0], losses
    (tl, tlosses), tg = value_and_grad(loss_fn, tp, ts, _torch_batch(b))
    for k in ('loss', 'giou_loss', 'conf_loss', 'class_loss'):
        np.testing.assert_allclose(float(tlosses[k][0]), float(jlosses[k][0]), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose([float(x[0]) for x in tlosses['loss_per_branch']],
                               [float(x[0]) for x in jlosses['loss_per_branch']], rtol=1e-5)
    want, _ = from_jax_params(jg, state, net.graph, device='cpu')
    top = max(t.abs().max().item() for t in tree_leaves(want))
    for a, w in zip(tree_leaves(tg), tree_leaves(want)):
        assert a.shape == w.shape
        assert ((a - w).abs() <= 1e-4 * w.abs() + 1e-5 * top).all()


@pytest.mark.parametrize('which', ['shallow', 'mobilenetv2'])
def test_bf16_step_matches_jax(which):
    """One jitted JAX step and one of the port's in bf16 compute (f32 BN
    statistics and loss), 64x64, B=2. Bounds: the shallow net's loss rtol
    1e-3, parts 5e-3, BN state 2e-3 * max(1, |s|) (measured 1.3e-4, 1.3e-3,
    2.7e-4: two bf16 walks round at other places); mobilenetv2-fpn's loss
    5e-2, parts 1e-1, BN state 3e-1 * max(1, |s|) (measured 1e-2, 3e-2,
    1.1e-1: the train-mode walk amplifies the bf16 roundings as it does f32
    ones, tests/test_torch_train_step.py)."""
    jnet, params, state, net, tp, ts = _models(which, seed=1)
    tol = {'shallow': (1e-3, 5e-3, 2e-3), 'mobilenetv2': (5e-2, 1e-1, 3e-1)}[which]
    jopt = jax_make_optimizer(schedule, grad_clip=1.0)
    jstep = jax.jit(jax_make_train_step(jnet, jopt, label_fn=_jax_label_fn,
                                        compute_dtype=jnp.bfloat16))
    opt = make_optimizer(schedule, grad_clip=1.0)
    step = make_train_step(net, opt, label_fn=LABELS, compute_dtype=torch.bfloat16)
    b = _batch(0)
    jp, js, _, jm = jstep(params, state, jopt.init(params), jax.tree.map(jnp.asarray, b),
                          jax.random.PRNGKey(0))
    p, s, _, m = step(tp, ts, opt.init(tp), _torch_batch(b))
    np.testing.assert_allclose(float(m['loss']), float(jm['loss']), rtol=tol[0])
    for k in ('giou_loss', 'conf_loss', 'class_loss'):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=tol[1], err_msg=k)
    _, want_s = from_jax_params(jax.device_get(jp), jax.device_get(js), net.graph, device='cpu')
    for key in want_s:
        for st in ('mean', 'var'):
            a, w = s[key][st], want_s[key][st]
            assert a.dtype == torch.float32
            assert (a - w).abs().max() <= tol[2] * w.abs().clamp_min(1.0).max(), (key, st)
    assert all(t.dtype == torch.float32 for t in tree_leaves(p))


def _run_step(net, tp, ts, remat, rng=None, batch=0):
    opt = make_optimizer(schedule, grad_clip=1.0)
    step = make_train_step(net, opt, label_fn=LABELS, remat=remat)
    return step(tp, ts, opt.init(tp), _torch_batch(_batch(batch)), rng)


@pytest.mark.parametrize('remat', [1, 2, 4])
def test_remat_matches_plain(remat):
    """``remat`` N runs the walk as N checkpointed segments: the loss,
    updated params and BN state equal the plain walk's (f32; the recompute
    runs the same ops, so equal to rounding: rtol 1e-6, atol 1e-7)."""
    *_, net, tp, ts = _models('mobilenetv2')
    p0, s0, _, m0 = _run_step(net, tp, ts, 0)
    p1, s1, _, m1 = _run_step(net, tp, ts, remat)
    for k in m0:
        np.testing.assert_allclose(m1[k].numpy(), m0[k].numpy(), rtol=1e-6)
    for a, b in zip(tree_leaves(p1) + tree_leaves(s1), tree_leaves(p0) + tree_leaves(s0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def _dropout_cfg():
    b = CfgBuilder()
    b.conv(8, size=3, stride=2)
    b.dropout(0.3)
    b.conv(16, size=3, stride=2)
    b.dropout(0.5)
    t8 = b.conv(16, size=3, stride=2)
    t16 = b.conv(16, size=3, stride=2)
    b.conv(16, size=3, stride=2)
    b.conv(75, size=1, bn=False, activation='linear')
    b.yolo(20)
    b.route(t16)
    b.conv(75, size=1, bn=False, activation='linear')
    b.yolo(20)
    b.route(t8)
    b.conv(75, size=1, bn=False, activation='linear')
    b.yolo(20)
    return b.text()


def test_dropout_replays_under_remat():
    """With dropout in a checkpointed segment, the recompute replays the
    segment's draws from the generator state it began with: remat 2 gives
    the plain walk's loss and params from the same seed, and leaves the
    caller's generator where the plain walk leaves it. Another seed gives
    another loss; no generator raises."""
    net = DetectionNetwork.from_cfg(_dropout_cfg())
    tp, ts = net.init(torch.Generator().manual_seed(0), device='cpu')
    gens = [torch.Generator().manual_seed(7) for _ in range(2)]
    p0, _, _, m0 = _run_step(net, tp, ts, 0, gens[0])
    p1, _, _, m1 = _run_step(net, tp, ts, 2, gens[1])
    np.testing.assert_allclose(m1['loss'].numpy(), m0['loss'].numpy(), rtol=1e-6)
    for a, b in zip(tree_leaves(p1), tree_leaves(p0)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    _, _, _, m2 = _run_step(net, tp, ts, 2, torch.Generator().manual_seed(8))
    assert float(m2['loss']) != float(m0['loss'])
    with pytest.raises(ValueError, match='Generator'):
        _run_step(net, tp, ts, 0, None)


def test_multi_step_equals_single_steps():
    """make_multi_step over 3 stacked batches gives the 3 single steps'
    params and stacked metrics (the same ops: rtol 1e-6)."""
    *_, net, tp, ts = _models('shallow')
    opt = make_optimizer(schedule, grad_clip=1.0)
    step = make_train_step(net, opt, label_fn=LABELS, probe_heads=True)
    p, s, o = tp, ts, opt.init(tp)
    single = []
    for k in range(3):
        p, s, o, m = step(p, s, o, _torch_batch(_batch(k)))
        single.append(m)
    stacked = {key: torch.stack([_torch_batch(_batch(k))[key] for k in range(3)])
               for key in ('image', 'gt')}
    p3, s3, o3, m3 = make_multi_step(step, 3)(tp, ts, opt.init(tp), stacked)
    assert o3['count'] == 3 and m3['head_max'].shape == (3, 3)
    for key in single[0]:
        np.testing.assert_allclose(m3[key].numpy(), torch.stack([m[key] for m in single]).numpy(),
                                   rtol=1e-6)
    for a, b in zip(tree_leaves(p3), tree_leaves(p)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)


def test_train_walk_options():
    """A train walk returns (preds, new state) and writes no input state;
    inference returns the preds alone; the options that do not combine
    raise, and the training entry takes no fused-IR table."""
    *_, net, tp, ts = _models('shallow')
    x = device_normalize(_torch_batch(_batch(0))['image'])
    before = {k: {n: t.clone() for n, t in v.items()} for k, v in ts.items()}
    preds, new_state = net.forward_train(tp, ts, x)
    assert preds.shape == (2, (8 * 8 + 4 * 4 + 2 * 2) * 3, 25)
    assert net(tp, ts, x).shape == preds.shape
    assert sorted(new_state) == sorted(ts) and not torch.equal(new_state['0']['mean'],
                                                               ts['0']['mean'])
    for k, v in before.items():
        for n, t in v.items():
            assert torch.equal(ts[k][n], t)
    with pytest.raises(TypeError, match='fused_ir'):
        net.forward_train(tp, ts, x, fused_ir={})
    with pytest.raises(ValueError, match='remat_segments'):
        net.forward_train(tp, ts, x, remat_segments=2, tap=lambda i, t: None)
    with pytest.raises(ValueError, match='probe_heads'):
        make_loss_fn(net, remat=2, probe_heads=True)


@pytest.mark.parametrize('case', ['f32_sparse_remat', 'bf16_probe_step_decay'])
def test_train_step_from_config(case):
    """The step the config builds is the step of the explicit arguments the
    config's fields name: the same params, BN state and metrics after two
    steps, bit for bit (a field the builder did not read would change
    them)."""
    *_, net, tp, ts = _models('shallow')
    cfg = Config()
    t = cfg.train
    t.weight_decay, t.grad_clip, t.warmup_epochs = 1e-3, 1.0, 0.5
    if case == 'f32_sparse_remat':
        cfg.system.compute_dtype = 'float32'
        cfg.sparse.switch, cfg.sparse.ratio = True, 0.02
        t.remat, t.head_probe = 2, False
        sched = cosine_warmup(t.learning_rate_init, t.learning_rate_end, 1, t.max_epochs * 2)
        kw = dict(sparse_ratio=0.02, sparse_ids=sparse_bn_gamma_ids(net), remat=2)
    else:
        t.scheduler, t.mile_stones = 'step', [1, 2]
        sched = step_decay_warmup(t.learning_rate_init, 1, 2, [1, 2], t.gamma)
        kw = dict(compute_dtype=torch.bfloat16, probe_heads=True)
    step, opt = train_step_from_config(net, cfg, steps_per_epoch=2, device='cpu')
    ref_opt = make_optimizer(sched, weight_decay=1e-3, grad_clip=1.0)
    ref = make_train_step(net, ref_opt, label_fn=LABELS, **kw)
    out = []
    for fn, o in ((step, opt), (ref, ref_opt)):
        p, s, st = tp, ts, o.init(tp)
        for k in range(2):
            p, s, st, m = fn(p, s, st, _torch_batch(_batch(k)))
        out.append((p, s, m))
    (p1, s1, m1), (p2, s2, m2) = out
    assert [opt.schedule(k) for k in range(4)] == [sched(k) for k in range(4)]
    assert sorted(m1) == sorted(m2) and ('head_max' in m1) == (case != 'f32_sparse_remat')
    for a, b in zip(tree_leaves(p1) + tree_leaves(s1) + [m1[k] for k in sorted(m1)],
                    tree_leaves(p2) + tree_leaves(s2) + [m2[k] for k in sorted(m2)]):
        assert torch.equal(a, b)


def test_training_entry_decodes_plain_off_the_cpu(monkeypatch):
    """``forward_train`` without targets decodes the heads with the plain,
    differentiable decode on every device: on meta tensors (standing in for
    the card) whose input requires grad it never calls ``decode_heads`` and
    returns preds that carry a grad_fn. The inference ``forward`` on the
    same input goes to ``decode_heads``, which refuses a non-CPU head that
    requires grad."""
    net = DetectionNetwork.from_cfg(_shallow_cfg())
    params, state = net.init(torch.Generator().manual_seed(0), device='cpu')
    mp, ms = to_device(params, torch.device('meta')), to_device(state, torch.device('meta'))
    x = torch.empty(2, 64, 64, 3, device='meta', requires_grad=True)
    calls = []
    real = network_module.decode_heads

    def spy(*args, **kwargs):
        calls.append(args[0][0].device)
        return real(*args, **kwargs)
    monkeypatch.setattr(network_module, 'decode_heads', spy)
    for train in (True, False):
        preds, new_state = net.forward_train(mp, ms, x, train=train)
        assert preds.device.type == 'meta' and preds.shape == (2, (8 * 8 + 4 * 4 + 2 * 2) * 3, 25)
        assert preds.grad_fn is not None and not calls
    with pytest.raises(RuntimeError, match='decode_heads: the kernel has no backward'):
        net(mp, ms, x)
    assert calls == [torch.device('meta')]
