"""Data parallelism of the port on the CPU: two gloo ranks, each holding half
of a global batch of 4, against one process on the whole batch and against
JAX's step on a 2-device mesh (``tests/conftest.py`` forces 8 host
devices).

One spawn of two ranks (``ranks``, module scope) runs every rank-side
check: sync-BN forward and backward, three data-parallel steps with
sparse-L1 and a binding global-norm clip, the QAT step's observers, device
augmentation with in-batch partners, and a Trainer (eval and checkpoints
on rank 0, a resume); the tests compare what the ranks wrote. The rank
side of this module imports no JAX: the spawned ranks import this module,
so JAX is imported inside the tests that run in the parent.

The step's tolerance: the walk with batch statistics amplifies rounding
(``tests/test_torch_train_step.py``), and the two ranks sum in another
order than one process, so after 3 steps the ranks' params are held to
2x JAX's own drift between its 1-device and 2-device-mesh ``jit_train_step``
on the same batches (L2 distance of all params). Weight decay is off there:
with L2 on, the elements whose clipped grad and ``weight_decay * param``
nearly cancel take an Adam update whose size rounding decides, and they
dominate any such distance (at weight decay 1e-3 the ranks lay 1.79e-5
from one process, JAX's 2-device mesh 7.7e-6 from its 1 device, and either
package on the batch reversed 2.4e-5 to 2.5e-5 from itself; at 0: 2.8e-6,
6.0e-6, and 1.5e-6 to 3.8e-6).
"""

import os

import numpy as np
import pytest
import torch

from pqdet_tpu_torch.compress.qat import prepare_qat_state
from pqdet_tpu_torch.config import Config, LATER_KEYS, load_config
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.ops.augment_device import augmenter_from_config, draw_augment
from pqdet_tpu_torch.ops.labels import label_assigner_from_config
from pqdet_tpu_torch.parallel import mesh
from pqdet_tpu_torch.model import layers as L
from pqdet_tpu_torch.train.step import (_inputs, make_optimizer, make_qat_train_step,
                                        make_train_step, sparse_bn_gamma_ids, tree_leaves)
from pqdet_tpu_torch.zoo import CfgBuilder

W, B, SIZE, MAX_GT, STEPS = 2, 4, 64, 16, 3
LR, WD, CLIP, SPARSE = 1e-3, 0.0, 1.0, 0.01
ANCHORS = np.array(Config().model.anchors, np.float32)


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


def schedule(k):
    return LR * (k + 1)


def _net_cfg():
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


def _batch(seed):
    """A global batch of B uint8 images and their padded GT boxes."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((B, MAX_GT, 6), np.float32)
    for i in range(B):
        n = rng.randint(3, MAX_GT + 1)
        cxy = rng.rand(n, 2) * (SIZE - 8) + 4
        wh = rng.rand(n, 2) * 40 + 4
        gt[i, :n] = np.concatenate([cxy - wh / 2, cxy + wh / 2, rng.randint(0, 20, (n, 1)),
                                    rng.rand(n, 1) * 0.5 + 0.5], 1)
    return {'image': rng.randint(0, 256, (B, SIZE, SIZE, 3)).astype(np.uint8), 'gt': gt}


def _rows(batch, r):
    """Rank r's shard of a global batch."""
    lb = B // W
    return {k: torch.from_numpy(v[r * lb:(r + 1) * lb].copy()) for k, v in batch.items()}


def _bn_case():
    g = torch.Generator().manual_seed(3)
    x = torch.randn(B, 16, 16, 8, generator=g) * 3 + 1
    params = {'gamma': torch.rand(8, generator=g) + 0.5, 'beta': torch.randn(8, generator=g)}
    state = {'mean': torch.randn(8, generator=g), 'var': torch.rand(8, generator=g) + 0.5}
    dy = torch.randn(B, 16, 16, 8, generator=g)
    return x, params, state, dy


def _bn_run(x, params, state, dy, group):
    """(y, new state, dx, dgamma, dbeta) of train-mode BN and the VJP of dy."""
    x = x.clone().requires_grad_(True)
    p = {k: v.clone().requires_grad_(True) for k, v in params.items()}
    y, new = L.batch_norm(x, p, state, True, group)
    (y * dy).sum().backward()
    return y.detach(), new, x.grad, p['gamma'].grad, p['beta'].grad


def _steps(net, params, state, group, r=None, qat=None):
    """STEPS steps of the port's step (the QAT step of phase ``qat``:
    (observing, bn_frozen)) on the global batches, or on rank r's rows of
    them; the (params, state, opt_state, metrics) after each."""
    opt = make_optimizer(schedule, weight_decay=WD, grad_clip=CLIP)
    labels = label_assigner_from_config(Config(), device='cpu')
    if qat is None:
        step = make_train_step(net, opt, sparse_ratio=SPARSE, sparse_ids=sparse_bn_gamma_ids(net),
                               label_fn=labels, group=group)
    else:
        step = make_qat_train_step(net, opt, observing=qat[0], bn_frozen=qat[1],
                                   label_fn=labels, group=group)
    p, s, o = params, state, opt.init(params)
    for tree in (p, s, o):
        mesh.broadcast_tree(tree, group=group)
    out = []
    for k in range(STEPS if qat is None else 1):
        b = _batch(k)
        b = {key: torch.from_numpy(v) for key, v in b.items()} if r is None else _rows(b, r)
        p, s, o, m = step(p, s, o, b)
        out.append((p, s, o, m))
    return out


def _augment_cfg():
    cfg = Config()
    a = cfg.augment
    a.device, a.mosaic_p, a.mixup_p, a.hflip_p, a.crop_p, a.color_p = True, 1.0, 1.0, 0.5, 0.5, 0.5
    return cfg


def _augmented(batch, group):
    """(normalized image, GT) of the step's device augmentation with the
    global batch's draws and in-batch mosaic and mixup partners."""
    draws = draw_augment(np.random.default_rng((0, 1)), B, SIZE)
    return _inputs({**batch, 'draws': draws}, lambda gt, size: gt,
                   augmenter_from_config(_augment_cfg()), group)


def _trainer_opts(root):
    return ['dataset.train_txt_file', f'{root}/list.txt', 'dataset.eval_txt_file',
            f'{root}/list.txt', 'dataset.classes', '[cat, dog, bird]',
            'model.cfg_path', f'{root}/tiny.cfg', 'model.max_gt_boxes', '8',
            'train.batch_size', str(B), 'train.input_sizes', f'[{SIZE}]',
            'train.max_epochs', '2', 'train.warmup_epochs', '1', 'eval.after', '1',
            'eval.batch_size', '2', 'eval.input_size', str(SIZE), 'eval.max_detections', '32',
            'weight.dir', f'{root}/weights', 'system.num_workers', '1',
            'system.compute_dtype', 'float32']


def _rank_trainer(dev, root, res):
    """Two epochs of a Trainer on this rank (eval after epoch 1), its evals
    and saves recorded; then a resume from the epoch-1 checkpoint."""
    from pqdet_tpu_torch.data.train_data import make_batch
    from pqdet_tpu_torch.train.trainer import Trainer
    calls = []

    class Recording(Trainer):
        def evaluate(self):
            calls.append('evaluate')
            return super().evaluate()

        def save(self, epoch):
            calls.append(f'save {epoch}')
            return super().save(epoch)

    opts = _trainer_opts(root)
    t = Recording(load_config(opts=opts), device=dev)
    t.run()
    res['calls'] = calls
    res['trainer'] = (t.global_step, [x.clone() for x in tree_leaves(t.params)],
                      [x.clone() for x in tree_leaves(t.state)])
    wdir = os.path.join(root, 'weights', 'VOC')
    last = [n for n in os.listdir(wdir) if n.startswith('model-1')][0]
    resumed = Trainer(load_config(opts=opts + ['train.max_epochs', '3', 'weight.resume',
                                               os.path.join(wdir, last)]), device=dev)
    resumed.init_all()
    rd, td = resumed.train_data, t.train_data
    res['resume'] = {
        'step': resumed.global_step, 'schedule': resumed.opt_state['schedule_count'],
        'params': all(torch.equal(a, b) for a, b in zip(tree_leaves(resumed.params),
                                                        tree_leaves(t.params))),
        'plan': (rd._indexes, rd._sizes) == (td._indexes, td._sizes),
        'rows': rd.batch_indices(),
        'batches': all(np.array_equal(make_batch(rd, i)[k], make_batch(td, i)[k])
                       for i in rd.batch_indices() for k in ('image', 'gt'))}
    resumed.close()
    try:
        Trainer(load_config(opts=opts + ['augment.device', 'on', 'dataset.device_cache', 'on',
                                         'train.unroll_steps', '2']), device=dev)
        res['cache_raises'] = False
    except ValueError as e:
        res['cache_raises'] = 'no unroll/spatial partitioning' in str(e)


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}


def _rank_work(dev, net_cfg, params, state, root):
    """Everything the ranks check, written to ``root/rank<r>.pt``."""
    group = mesh.active_group()
    r = mesh.rank()
    lb = B // W
    params, state = _clone(params), _clone(state)    # the parent's tensors stay its own
    res = {'world': mesh.world(), 'group': group is not None}
    x, bp, bs, dy = _bn_case()
    res['bn'] = _bn_run(x[r * lb:(r + 1) * lb], bp, bs, dy[r * lb:(r + 1) * lb], group)
    net = DetectionNetwork.from_cfg(net_cfg)
    res['steps'] = _steps(net, params, state, group, r)
    qnet = DetectionNetwork.from_cfg(net_cfg, quant=True)
    qp, qs = prepare_qat_state(qnet, params, state)
    res['qat'] = {phase: _steps(qnet, qp, qs, group, r, qat=phase)[0][1]['quant']
                  for phase in ((True, False), (True, True))}
    res['augment'] = _augmented(_rows(_batch(7), r), group)
    _rank_trainer(dev, root, res)
    torch.save(res, os.path.join(root, f'rank{r}.pt'))


# ------------------------------------------------------------- the parent

@pytest.fixture(scope='module')
def model():
    import jax
    from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
    from pqdet_tpu_torch.bridge import from_jax_params
    text = _net_cfg()
    jnet = JaxNetwork.from_cfg(text)
    params, state = jnet.init(jax.random.PRNGKey(1))
    net = DetectionNetwork.from_cfg(text)
    tp, ts = from_jax_params(params, state, net.graph, device='cpu')
    return text, jnet, params, state, net, tp, ts


@pytest.fixture(scope='module')
def ranks(model, tmp_path_factory):
    """The two ranks' results (one spawn), and the fixture directory."""
    from test_data import _write_voc_fixture
    from test_e2e import TINY_DET
    text, *_, tp, ts = model
    root = str(tmp_path_factory.mktemp('parallel'))
    txt = _write_voc_fixture(root, n=8)
    os.replace(txt, os.path.join(root, 'list.txt'))
    with open(os.path.join(root, 'tiny.cfg'), 'w') as fw:
        fw.write(TINY_DET)
    mesh.launch(_rank_work, W, 'cpu', 'gloo', (text, tp, ts, root), timeout_s=300)
    return [torch.load(os.path.join(root, f'rank{r}.pt'), weights_only=False)
            for r in range(W)], root


def _flat(tree):
    return torch.cat([t.reshape(-1).float() for t in tree_leaves(tree)])


@pytest.mark.parametrize('batch,devices', [(12, 8), (12, 5), (4, 2), (7, 4), (16, 16),
                                           (1, 8), (12, 1), (6, 4)])
def test_fit_and_pad_match_jax(batch, devices):
    from pqdet_tpu.parallel import mesh as jax_mesh
    assert mesh.fit_mesh_to_batch(batch, devices) == jax_mesh.fit_mesh_to_batch(batch, devices)
    assert mesh.pad_batch_to_devices(batch, devices) == \
        jax_mesh.pad_batch_to_devices(batch, devices)


def test_world_resolution_and_guards(monkeypatch):
    """system.data_devices on the CPU counts gloo processes (0 = one),
    capped by the batch; NCCL refuses the CPU and ranks sharing a GPU
    before any group exists; the spatial mesh raises without a process
    group, never falling back to one process; without a group nothing
    communicates."""
    assert mesh.resolve_world(0, 12, 'cpu') == 1
    assert mesh.resolve_world(5, 12, 'cpu') == 4 and mesh.resolve_world(2, 4, 'cpu') == 2
    assert (mesh.world(), mesh.rank(), mesh.is_main(), mesh.active_group()) == (1, 0, True, None)
    t = torch.arange(4.0)
    assert mesh.all_reduce_mean_(t) is t and mesh.all_gather_batch(t) is t
    with pytest.raises(ValueError, match='gloo'):
        mesh.check_backend('nccl', 'cpu', 1)
    monkeypatch.setattr(torch.distributed, 'is_nccl_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(ValueError, match='share a device; use backend gloo'):
        mesh.launch(_rank_work, 2, 'cuda', 'nccl')
    with pytest.raises(ValueError, match='not one of'):
        mesh.check_backend('mpi', 'cpu', 1)
    with pytest.raises(ValueError, match='needs a process group of 4 ranks'):
        mesh.make_mesh_2d(2, 2)
    ctx = mesh.SpatialCtx(2, 2, 0, 1, None, None, None)
    assert mesh.spatial_batch_shardings(ctx, 4, 64) == {'image': (slice(0, 2), slice(32, 64)),
                                                        'gt': (slice(0, 2),)}


def test_config_keys():
    """system.data_devices, train.spatial and train.unroll_steps load with
    JAX's defaults and values, and no key is queued any more; cli.search and
    cli.evolute launch their ranks as cli.train does (a world the batch
    and data_devices resolve, with spatial ranks counted)."""
    from pqdet_tpu.config import load_config as jax_load_config
    cfg = load_config(opts=['system.data_devices', '2'])
    assert cfg.system.data_devices == 2 == jax_load_config(
        opts=['system.data_devices', '2']).system.data_devices
    assert Config().system.data_devices == 0
    spatial = load_config(opts=['train.spatial', '2'])
    assert spatial.train.spatial == 2 == jax_load_config(
        opts=['train.spatial', '2']).train.spatial
    assert Config().train.spatial == 0 == jax_load_config().train.spatial
    assert LATER_KEYS == {}
    assert load_config(opts=['train.unroll_steps', '2']).train.unroll_steps == 2 == \
        jax_load_config(opts=['train.unroll_steps', '2']).train.unroll_steps
    assert Config().train.unroll_steps == 1 == jax_load_config().train.unroll_steps
    assert mesh.resolve_world(cfg.system.data_devices, cfg.train.batch_size, 'cpu',
                              cfg.train.spatial) == 2
    assert mesh.resolve_world(0, 12, 'cpu', spatial.train.spatial) == 2


@pytest.fixture(scope='module')
def voc(tmp_path_factory):
    from test_data import _write_voc_fixture
    from test_e2e import TINY_DET
    root = str(tmp_path_factory.mktemp('voc'))
    txt = _write_voc_fixture(root, n=10)
    with open(os.path.join(root, 'tiny.cfg'), 'w') as fw:
        fw.write(TINY_DET)
    return root, ['dataset.train_txt_file', txt, 'dataset.eval_txt_file', txt,
                  'dataset.classes', '[cat, dog, bird]', 'model.cfg_path',
                  os.path.join(root, 'tiny.cfg'), 'model.max_gt_boxes', '8',
                  'train.batch_size', str(B), 'train.input_sizes', '[64, 96]',
                  'augment.mosaic_p', '0.5', 'augment.mixup_p', '0.5']


def test_batch_indices_match_jax(voc):
    """Each rank's slots are JAX's TrainData(num_hosts=2, host_id=r)'s, on
    the same plan; a batch W does not divide raises in both."""
    from pqdet_tpu.config import load_config as jax_load_config
    from pqdet_tpu.data.train_data import TrainData as JaxTrainData
    from pqdet_tpu_torch.data.train_data import TrainData
    _, opts = voc
    cfg, jcfg = load_config(opts=opts), jax_load_config(opts=opts)
    for r in range(W):
        ours, theirs = TrainData(cfg, num_hosts=W, host_id=r), JaxTrainData(jcfg, W, r)
        assert ours.batch_indices() == theirs.batch_indices()
        assert (ours._indexes, ours._sizes) == (theirs._indexes, theirs._sizes)
        assert ours.local_batch_size == B // W
    for make in (TrainData, JaxTrainData):
        with pytest.raises(ValueError, match='divisible by num_hosts'):
            make(cfg if make is TrainData else jcfg, num_hosts=3, host_id=0)


@pytest.mark.parametrize('loader', ['thread', 'process'])
def test_rank_rows_equal_one_process_rows(voc, loader):
    """Rank r's batches, on either loader, are rows [r*B/W, (r+1)*B/W) of
    the one-process batches bit for bit (two epochs of three batches, mosaic
    and mixup partners)."""
    from pqdet_tpu_torch.data.train_data import ProcessLoader, TrainData, epoch_batches
    _, opts = voc
    cfg = load_config(opts=opts)

    def epochs(data):
        out = []
        loader_ = ProcessLoader(data, 1, prefetch=2) if loader == 'process' else None
        try:
            for _ in range(2):
                out += list(loader_.epoch() if loader_ else epoch_batches(data, 2))
                data.init_shuffle()
        finally:
            if loader_:
                loader_.close()
        return out

    whole = epochs(TrainData(cfg))
    shards = [epochs(TrainData(cfg, num_hosts=W, host_id=r)) for r in range(W)]
    lb = B // W
    assert len(whole) == 6
    for k, full in enumerate(whole):
        for r in range(W):
            for key in ('image', 'gt'):
                assert shards[r][k][key].shape[0] == lb
                assert np.array_equal(shards[r][k][key], full[key][r * lb:(r + 1) * lb])


def test_sync_bn_matches_whole_batch_and_jax_mesh(ranks):
    """The two ranks' BN against BN on the whole batch in one process and
    against JAX's train-mode batch_norm jitted on a 2-device mesh: y, the
    new running mean and variance, and the VJP's dx (rows of each rank),
    dgamma and dbeta (summed over the ranks, as the step's all-reduce sums
    them) within rtol 1e-5, atol 1e-5 of their largest element; the ranks'
    running statistics equal bit for bit."""
    import jax
    import jax.numpy as jnp
    from pqdet_tpu.model.layers import batch_norm as jax_batch_norm
    from pqdet_tpu.parallel.mesh import batch_sharding, make_mesh, replicated
    (r0, r1), _ = ranks
    assert r0['world'] == r1['world'] == W and r0['group']
    x, params, state, dy = _bn_case()
    got = (torch.cat([r0['bn'][0], r1['bn'][0]]), r0['bn'][1]['mean'], r0['bn'][1]['var'],
           torch.cat([r0['bn'][2], r1['bn'][2]]), r0['bn'][3] + r1['bn'][3],
           r0['bn'][4] + r1['bn'][4])
    for st in ('mean', 'var'):
        assert torch.equal(r0['bn'][1][st], r1['bn'][1][st])
    y, new, dx, dg, db = _bn_run(x, params, state, dy, None)
    one = (y, new['mean'], new['var'], dx, dg, db)

    m2 = make_mesh(2)
    jstate = {k: jnp.asarray(v.numpy()) for k, v in state.items()}

    def f(xx, p):
        y_, s_ = jax_batch_norm(xx, p, jstate, True)
        return y_, s_

    def vjp(xx, p, ct):
        (y_, s_), pull = jax.vjp(lambda a, b: f(a, b), xx, p)
        dx_, dp_ = pull((ct, jax.tree.map(jnp.zeros_like, s_)))
        return y_, s_['mean'], s_['var'], dx_, dp_['gamma'], dp_['beta']

    jp = {k: jax.device_put(v.numpy(), replicated(m2)) for k, v in params.items()}
    jit = jax.jit(vjp, in_shardings=(batch_sharding(m2), replicated(m2), batch_sharding(m2)))
    theirs = [torch.from_numpy(np.array(a)) for a in
              jit(jax.device_put(x.numpy(), batch_sharding(m2)), jp,
                  jax.device_put(dy.numpy(), batch_sharding(m2)))]
    for name, a, b, c in zip(('y', 'mean', 'var', 'dx', 'dgamma', 'dbeta'), got, one, theirs):
        tol = 1e-5 * float(b.abs().max())
        for ref, who in ((b, 'one process'), (c, 'JAX 2-device mesh')):
            torch.testing.assert_close(a, ref, rtol=1e-5, atol=tol, msg=f'{name} vs {who}')


def _jax_steps(model, n_dev):
    """STEPS jitted JAX steps on an n_dev mesh (sparse-L1, clip), the
    params and BN state after the last."""
    import jax
    import jax.numpy as jnp
    from pqdet_tpu.ops.labels import assign_labels_device as jax_assign
    from pqdet_tpu.parallel.mesh import batch_sharding, make_mesh, replicated
    from pqdet_tpu.train.step import jit_train_step
    from pqdet_tpu.train.step import make_optimizer as jax_make_optimizer
    from pqdet_tpu.train.step import make_train_step as jax_make_train_step
    from pqdet_tpu.train.step import sparse_bn_gamma_ids as jax_sparse_ids
    _, jnet, params, state, *_ = model
    m = make_mesh(n_dev)
    opt = jax_make_optimizer(schedule, weight_decay=WD, grad_clip=CLIP)
    step = jit_train_step(jax_make_train_step(
        jnet, opt, sparse_ratio=SPARSE, sparse_ids=jax_sparse_ids(jnet),
        label_fn=lambda gt, size: jax_assign(gt, size, [8, 16, 32], ANCHORS, 20)), m)
    host = jax.device_get((params, state))
    p, s = jax.device_put(host, replicated(m))
    o = jax.device_put(jax.device_get(opt.init(params)), replicated(m))
    for k in range(STEPS):
        b = jax.device_put(_batch(k), batch_sharding(m))
        p, s, o, _ = step(p, s, o, b, jax.random.PRNGKey(k))
    return jax.device_get(p), jax.device_get(s)


def test_step_ranks_identical_and_within_jax_drift(model, ranks):
    """After each of 3 steps (sparse-L1 and a binding clip on) the two
    ranks' params, BN state and optimizer state are identical bit for bit
    and their metrics equal; against the one-process step on the global
    batches the loss parts agree to rtol 1e-4 each step, and the params
    after 3 steps lie within 2x JAX's own distance between its 1-device and
    2-device-mesh steps (L2 over all params)."""
    from pqdet_tpu_torch.bridge import from_jax_params
    (r0, r1), _ = ranks
    *_, net, tp, ts = model
    one = _steps(net, tp, ts, None)
    for k in range(STEPS):
        (p0, s0, o0, m0), (p1, s1, o1, m1) = r0['steps'][k], r1['steps'][k]
        for a, b in zip(tree_leaves(p0) + tree_leaves(s0) + [o0['mu'], o0['nu']],
                        tree_leaves(p1) + tree_leaves(s1) + [o1['mu'], o1['nu']]):
            assert torch.equal(a, b), k
        assert (o0['count'], o0['schedule_count']) == (o1['count'], o1['schedule_count']) \
            == (k + 1, k + 1)
        assert all(torch.equal(m0[n], m1[n]) for n in m0)
        for name in ('loss', 'giou_loss', 'conf_loss', 'class_loss', 'loss_per_branch'):
            torch.testing.assert_close(m0[name], one[k][3][name], rtol=1e-4, atol=0.0,
                                       msg=f'step {k} {name}')
    want = _flat(one[-1][0])
    gap = (_flat(r0['steps'][-1][0]) - want).norm().item()
    j1, j2 = _jax_steps(model, 1), _jax_steps(model, 2)
    f1 = _flat(from_jax_params(*j1, net.graph, device='cpu')[0])
    f2 = _flat(from_jax_params(*j2, net.graph, device='cpu')[0])
    drift = (f1 - f2).norm().item()
    print(f'after {STEPS} steps: the ranks {gap:.4g} from one process; JAX 2-device mesh '
          f'{drift:.4g} from 1 device; the port {(want - f1).norm().item():.4g} from JAX')
    assert gap <= 2 * drift


def test_qat_observers_global(model, ranks):
    """The QAT step's new observers are identical on both ranks and equal
    the one-process step's exactly (min and max are exact), with BN frozen
    and with BN on batch statistics for the input's observer (later edges
    see sync-BN's rounding there: within 1e-5 of the range)."""
    (r0, r1), _ = ranks
    text, *_, tp, ts = model
    qnet = DetectionNetwork.from_cfg(text, quant=True)
    qp, qs = prepare_qat_state(qnet, tp, ts)
    for phase in ((True, False), (True, True)):
        one = _steps(qnet, qp, qs, None, qat=phase)[0][1]['quant']
        a, b = r0['qat'][phase], r1['qat'][phase]
        assert sorted(a) == sorted(one) and len(a) > 5
        for key in one:
            for f in ('min', 'max', 'initialized'):
                assert torch.equal(a[key][f], b[key][f]), (phase, key, f)
                if phase[1] or key == 'input' or f == 'initialized':
                    assert torch.equal(a[key][f], one[key][f]), (phase, key, f)
                else:
                    span = float(one[key]['max'] - one[key]['min'])
                    assert abs(float(a[key][f] - one[key][f])) <= 1e-5 * max(span, 1.0)


def test_device_augment_rows_with_partners(ranks):
    """Device augmentation with mosaic and mixup on (in-batch partners):
    each rank's augmented rows and GT equal the one-process augmented
    batch's rows bit for bit."""
    (r0, r1), _ = ranks
    b = _batch(7)
    image, gt = _augmented({k: torch.from_numpy(v) for k, v in b.items()}, None)
    lb = B // W
    for r, res in enumerate((r0, r1)):
        assert torch.equal(res['augment'][0], image[r * lb:(r + 1) * lb])
        assert torch.equal(res['augment'][1], gt[r * lb:(r + 1) * lb])


def test_trainer_ranks(ranks):
    """The Trainer in two ranks: rank 0 alone evaluates (after epoch 1) and
    writes both checkpoints, which the JAX package reads; both ranks end
    with the same params and BN state; a resume from the epoch-1 checkpoint
    starts at step 4 with the schedule there, the checkpoint's params, and
    each rank's rows of the uninterrupted run's next epoch; the device
    corpus, which now runs at two ranks, still refuses unrolled steps, as
    JAX's does."""
    from pqdet_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
    (r0, r1), root = ranks
    assert r0['calls'] == ['save 0', 'evaluate', 'save 1'] and r1['calls'] == []
    (s0, p0, b0), (s1, p1, b1) = r0['trainer'], r1['trainer']
    assert s0 == s1 == 4
    assert all(torch.equal(a, b) for a, b in zip(p0 + b0, p1 + b1))
    wdir = os.path.join(root, 'weights', 'VOC')
    names = sorted(os.listdir(wdir))
    assert len(names) == 2 and names[0] == 'model-0.ckpt' and names[1].startswith('model-1-')
    assert jax_load_checkpoint(os.path.join(wdir, names[1]))['step'] == 4
    for r, res in enumerate((r0, r1)):
        rs = res['resume']
        assert (rs['step'], rs['schedule'], rs['params'], rs['plan'], rs['batches']) == \
            (4, 4, True, True, True)
        assert rs['rows'] == [[k * B + r * 2, k * B + r * 2 + 1] for k in range(2)]
        assert res['cache_raises']


def test_train_cli_two_gloo_ranks(tmp_path, capfd):
    """``cli.train --device cpu system.data_devices 2``: two spawned gloo
    ranks train one epoch and evaluate; only rank 0 prints the config and
    the AP table, and the one checkpoint is read by the JAX package with
    the step of the global batches (2 of 4 images over 8)."""
    from pqdet_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
    from pqdet_tpu_torch.cli import train as cli_train
    from test_data import _write_voc_fixture
    from test_e2e import TINY_DET
    txt = _write_voc_fixture(str(tmp_path), n=8)
    (tmp_path / 'tiny.cfg').write_text(TINY_DET)
    opts = [o.replace(f'{tmp_path}/list.txt', txt) for o in _trainer_opts(str(tmp_path))]
    cli_train.main(['--device', 'cpu', '--dist-backend', 'gloo']
                   + opts + ['train.max_epochs', '1', 'eval.after', '0',
                             'system.data_devices', '2'])
    out = capfd.readouterr().out
    assert out.count('Config(experiment_name') == 1 and out.count('mAPs') == 1
    assert 'data_devices=2' in out
    wdir = tmp_path / 'weights' / 'VOC'
    names = os.listdir(wdir)
    assert len(names) == 1 and names[0].startswith('model-0-')
    ckpt = jax_load_checkpoint(str(wdir / names[0]))
    assert ckpt['step'] == 2 and ckpt['cfg'] == TINY_DET


def test_world_one_is_the_one_process_step(model, monkeypatch):
    """In a process group of one rank the step gets no group and runs the
    one-process code: no collective, and its params, state and metrics
    equal the step built without a group bit for bit."""
    text, *_, net, tp, ts = model
    mesh.init_process_group('gloo', rank=0, world_size=1, master_port=mesh.free_port(),
                            device='cpu', timeout_s=60)
    try:
        assert (mesh.world(), mesh.active_group()) == (1, None)

        def no_collective(*args, **kwargs):
            raise AssertionError('a collective at world size 1')
        for name in ('all_reduce', 'all_gather', 'broadcast', 'barrier'):
            monkeypatch.setattr(torch.distributed, name, no_collective)
        got = _steps(net, tp, ts, mesh.active_group())
    finally:
        monkeypatch.undo()
        mesh.destroy_process_group()
    want = _steps(net, tp, ts, None)
    for (p0, s0, _, m0), (p1, s1, _, m1) in zip(got, want):
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p0) + tree_leaves(s0),
                                                     tree_leaves(p1) + tree_leaves(s1)))
        assert all(torch.equal(m0[n], m1[n]) for n in m0)


def test_dead_rank_fails_launch():
    """A rank that raises ends the launch with an error, not a hang: the
    error is the dead rank's, or the other rank's failed collective,
    whichever the launcher sees first."""
    import time
    from torch.multiprocessing.spawn import ProcessException
    t0 = time.perf_counter()
    with pytest.raises(ProcessException):
        mesh.launch(_dying_rank, W, 'cpu', 'gloo', timeout_s=60)
    assert time.perf_counter() - t0 < 60


def _dying_rank(dev):
    if mesh.rank() == 1:
        raise RuntimeError('rank 1 dies')
    mesh.barrier()
