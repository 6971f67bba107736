"""Unrolled train steps (``train.unroll_steps``) of the port against the JAX
package on the CPU: JAX's ``test_trainer_unrolled_steps`` and
``test_multi_step_unroll_equivalence`` ported, the port's K-step loop
against JAX's scanned ``make_multi_step``, the epoch plan's size groups
against JAX's ``TrainData``, and the refusals JAX makes.

A group of K steps is a plain loop in the port (JAX scans it), so it is
held to K single steps bit for bit; against JAX it is held to 2x JAX's own
drift on the reversed batches, the yardstick of
``tests/test_torch_train_step.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from pqdet_tpu.train.step import make_multi_step as jax_make_multi_step
from pqdet_tpu.train.step import make_optimizer as jax_make_optimizer
from pqdet_tpu.train.step import make_train_step as jax_make_train_step
from pqdet_tpu_torch.bridge import from_jax_params
from pqdet_tpu_torch.config import Config, load_config
from pqdet_tpu_torch.data.train_data import TrainData
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.ops.labels import label_assigner_from_config
from pqdet_tpu_torch.train.step import (make_multi_step, make_optimizer, make_train_step,
                                        stack_batches, tree_leaves)
from pqdet_tpu_torch.train.trainer import Trainer
from test_data import _write_voc_fixture
from test_e2e import TINY_DET
from test_torch_train_step import (JaxNetwork, _batch, _jax_label_fn, _reversed, _shallow_cfg,
                                   _torch_batch, schedule)

K = 4
LABELS = label_assigner_from_config(Config(), device='cpu')


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small CPU ops: beside the
    suite's other workers, an op split over all cores waits at its barrier
    for threads those workers hold (a 64 px int8 walk of
    ``test_kernel_mode_plain_flag_and_launches`` took 0.2 s alone and 35 s
    beside five busy processes, 0.8 s on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return torch.cat([t.reshape(-1).double() for t in tree_leaves(tree)])


def _opts(tmp_path, n=4, *extra):
    txt = _write_voc_fixture(str(tmp_path), n=n)
    (tmp_path / 'tiny.cfg').write_text(TINY_DET)
    return ['dataset.train_txt_file', txt, 'dataset.eval_txt_file', txt,
            'dataset.classes', '[cat, dog, bird]', 'model.cfg_path', str(tmp_path / 'tiny.cfg'),
            'model.max_gt_boxes', '8', 'train.batch_size', '2', 'train.input_sizes', '[64]',
            'train.max_epochs', '1', 'train.warmup_epochs', '1', 'eval.after', '0',
            'eval.batch_size', '2', 'eval.input_size', '64', 'eval.max_detections', '32',
            'weight.dir', str(tmp_path / 'weights'), 'system.num_workers', '2', *extra]


def test_trainer_unrolled_steps(tmp_path):
    """JAX's ``tests/test_e2e.py::test_trainer_unrolled_steps`` in the port:
    4 images at batch 2 give one group of 2 steps, and the epoch's eval
    gives an AP. The group is the two single steps of a ``unroll_steps`` 1
    run on the same plan: the same params and BN state bit for bit."""
    runs = {}
    for k in (2, 1):
        trainer = Trainer(load_config(opts=_opts(tmp_path / f'k{k}', 4, 'train.unroll_steps',
                                                 str(k))), device='cpu')
        trainer.run()
        runs[k] = trainer
    t2, t1 = runs[2], runs[1]
    assert t2.global_step == 2 and t2.steps_per_epoch == 2
    assert t2.AP is not None and 0.0 <= t2.AP.AP <= 1.0
    assert t2.step_fn.__name__ == 'multi_step' and t1.step_fn.__name__ != 'multi_step'
    assert torch.equal(_flat(t2.params), _flat(t1.params))
    assert torch.equal(_flat(t2.state), _flat(t1.state))


def _mesh_cfg():
    """JAX's ``get_mesh_cfg``: a tiny 3-head net at strides 8, 16, 32."""
    from pqdet_tpu_torch.zoo import CfgBuilder
    b = CfgBuilder()
    b.conv(8, size=3, stride=2)
    b.conv(16, size=3, stride=2)
    t8 = b.conv(16, size=3, stride=2)
    t16 = b.conv(24, size=3, stride=2)
    b.conv(32, size=3, stride=2)
    b.conv(27, size=1, bn=False, activation='linear')
    b.yolo(4)
    b.route(t16)
    b.conv(27, size=1, bn=False, activation='linear')
    b.yolo(4)
    b.route(t8)
    b.conv(27, size=1, bn=False, activation='linear')
    b.yolo(4)
    return b.text()


def _target_batch(b, hw, nc=4, a=3, n_gt=6, strides=(8, 16, 32), seed=0):
    """JAX's ``tests/test_train_step.py::_make_batch``: float images and
    host targets (background label grids, empty box lists)."""
    rng = np.random.RandomState(seed)
    labels, gts = [], []
    for s in strides:
        lab = np.zeros((b, hw // s, hw // s, a, 6 + nc), np.float32)
        lab[..., -1] = 1.0
        labels.append(torch.from_numpy(lab))
        gts.append(torch.zeros((b, n_gt, 4)))
    return {'image': torch.from_numpy(rng.rand(b, hw, hw, 3).astype(np.float32)),
            'targets': tuple(labels + gts)}


def test_multi_step_unroll_equivalence():
    """JAX's ``tests/test_train_step.py::test_multi_step_unroll_equivalence``
    in the port: a 4-step dispatch on the same batch stacked 4 times lands
    on the params of 4 single steps with the same batch and generators
    (JAX: rtol 1e-4; the port's loop runs the same ops: bit for bit), and
    its stacked losses are the single steps' losses."""
    net = DetectionNetwork.from_cfg(_mesh_cfg())
    params, state = net.init(torch.Generator().manual_seed(0), device='cpu')
    opt = make_optimizer(lambda k: 1e-3 * min(1.0, (k + 1) / 100))
    step = make_train_step(net, opt)
    batch = _target_batch(8, 64)
    gens = [torch.Generator().manual_seed(1) for _ in range(2)]
    p1, s1, o1 = params, state, opt.init(params)
    single = []
    for _ in range(K):
        p1, s1, o1, m = step(p1, s1, o1, batch, gens[0])
        single.append(float(m['loss']))
    p2, s2, o2, m = make_multi_step(step, K)(params, state, opt.init(params),
                                             stack_batches([batch] * K), [gens[1]] * K)
    assert m['loss'].shape == (K,) and m['loss'].tolist() == single
    assert o2['count'] == o1['count'] == K
    assert torch.equal(_flat(p2), _flat(p1)) and torch.equal(_flat(s2), _flat(s1))
    assert torch.equal(o2['mu'], o1['mu']) and torch.equal(o2['nu'], o1['nu'])


def test_multi_step_matches_jax_scan():
    """The port's 4-step loop against ``jax.jit`` of JAX's scanned
    ``make_multi_step`` on the same weights and 4 batches (the shallow net
    of ``tests/test_torch_train_step.py``, 64 px, B=2, device labels, a
    binding clip): each step's loss within 1e-3 (the first 1e-5), and the
    params after the dispatch within 2x JAX's own distance between its
    dispatch on the batches and on the batches reversed."""
    jnet = JaxNetwork.from_cfg(_shallow_cfg())
    params, state = jnet.init(jax.random.PRNGKey(0))
    net = DetectionNetwork.from_cfg(_shallow_cfg())
    tp, ts = from_jax_params(params, state, net.graph, device='cpu')
    jopt = jax_make_optimizer(schedule, grad_clip=1.0)
    jmulti = jax.jit(jax_make_multi_step(jax_make_train_step(jnet, jopt, label_fn=_jax_label_fn),
                                         K))
    runs = {}
    for name, order in (('jax', lambda b: b), ('reversed', _reversed)):
        stacked = {key: jnp.stack([jnp.asarray(order(_batch(k))[key]) for k in range(K)])
                   for key in ('image', 'gt')}
        p, _, _, m = jmulti(params, state, jopt.init(params), stacked,
                            jax.random.split(jax.random.PRNGKey(1), K))
        runs[name] = (from_jax_params(jax.device_get(p), state, net.graph, device='cpu')[0],
                      np.asarray(m['loss']))
    opt = make_optimizer(schedule, grad_clip=1.0)
    step = make_train_step(net, opt, label_fn=LABELS)
    stacked = stack_batches([_torch_batch(_batch(k)) for k in range(K)])
    p, _, o, m = make_multi_step(step, K)(tp, ts, opt.init(tp), stacked)
    assert o['count'] == K and m['loss'].shape == (K,)
    jl = runs['jax'][1]
    np.testing.assert_allclose(m['loss'][0].item(), jl[0], rtol=1e-5)
    np.testing.assert_allclose(m['loss'].numpy(), jl, rtol=1e-3)
    want = _flat(runs['jax'][0])
    gap = (_flat(p) - want).norm().item()
    own = (_flat(runs['reversed'][0]) - want).norm().item()
    print(f'{K} unrolled steps: the port {gap:.4g} (L2) from JAX\'s scan, JAX on the reversed '
          f'batches {own:.4g} from it')
    assert 0 < own and gap <= 2 * own


@pytest.mark.parametrize('k', [1, 2, 3])
def test_epoch_plan_matches_jax(tmp_path, k):
    """``TrainData``'s epoch plan at ``train.unroll_steps`` K against JAX's,
    two epochs: ``batches_per_epoch`` rounded up to whole groups, the sample
    indices, and one size per group of K batches, the first group at the
    largest size (7 images at batch 2, three input sizes)."""
    from pqdet_tpu.config import load_config as jax_load_config
    from pqdet_tpu.data.train_data import TrainData as JaxTrainData
    opts = _opts(tmp_path, 7, 'train.input_sizes', '[64, 96, 128]', 'system.label_assign',
                 'device', 'train.unroll_steps', str(k))
    ours, theirs = TrainData(load_config(opts=opts)), JaxTrainData(jax_load_config(opts=opts))
    assert ours.batches_per_epoch == theirs.batches_per_epoch == -(-4 // k) * k
    for epoch in range(2):
        if epoch:
            ours.init_shuffle()
            theirs.init_shuffle()
        assert ours._indexes == theirs._indexes
        assert [tuple(s) for s in ours._sizes] == [tuple(s) for s in theirs._sizes]
        assert all(len({tuple(s) for s in ours._sizes[g:g + k]}) == 1
                   for g in range(0, len(ours._sizes), k))
        assert all(tuple(s) == (128, 128) for s in ours._sizes[:k])
    if k == 1:      # the plan of a config without the key is the same
        plain, one = TrainData(load_config(opts=opts[:-2])), TrainData(load_config(opts=opts))
        assert (plain._indexes, plain._sizes) == (one._indexes, one._sizes)


def test_unroll_refusals_match_jax(tmp_path):
    """``train.unroll_steps`` 2 with ``train.spatial`` 2 and with the device
    corpus raise ``ValueError`` in both packages, with JAX's messages."""
    from pqdet_tpu.config import load_config as jax_load_config
    from pqdet_tpu.train.trainer import Trainer as JaxTrainer
    opts = _opts(tmp_path, 4, 'train.unroll_steps', '2')
    for extra, match in ((['train.spatial', '2'], 'train.spatial excludes unroll_steps > 1'),
                         (['augment.device', 'on', 'dataset.device_cache', 'on'],
                          'no unroll/spatial partitioning')):
        with pytest.raises(ValueError, match=match):
            Trainer(load_config(opts=opts + extra), device='cpu')
        with pytest.raises(ValueError, match=match):
            JaxTrainer(jax_load_config(opts=opts + extra)).init_all()
