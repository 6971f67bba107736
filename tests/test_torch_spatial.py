"""Spatial partitioning of the port (``train.spatial``) on the CPU: four gloo
ranks as a (2 data x 2 space) mesh, each holding half of a global batch of
4 at 128 px and one band of 64 rows of it, against one process on the
whole batch and against JAX's unsharded step and its ``make_mesh_2d(2, 2)``
step (``tests/conftest.py`` forces 8 host devices).

One spawn of four ranks (``ranks``, module scope) runs every rank-side
check: each op kind on bands, forward and backward; three spatial steps
with sparse-L1 and a binding global-norm clip; the QAT step's observers;
a step with the s2d stem and one with ``remat_segments``; a step at an
input height the bands do not divide (walked padded); the errors of a
halo deeper than a band and of an input height the total stride does not
divide; and a Trainer (eval and checkpoints on rank 0). The tests compare what
the ranks wrote. The rank side of this module imports no JAX: the spawned
ranks import this module, so JAX is imported inside the tests that run in
the parent.

The step's tolerance is ``tests/test_torch_parallel.py``'s: the walk with
batch statistics amplifies rounding, and the ranks sum in another order
than one process, so after 3 steps the ranks' params are held to 2x JAX's
own drift between its unsharded step and its 2 x 2 mesh step (L2 distance
of all params), with weight decay off (see that module's docstring).
"""

import os

import numpy as np
import pytest
import torch

from pqdet_tpu_torch.compress.qat import prepare_qat_state
from pqdet_tpu_torch.config import Config, load_config
from pqdet_tpu_torch.model import layers as L
from pqdet_tpu_torch.model.decode import decode
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.ops.labels import label_assigner_from_config
from pqdet_tpu_torch.parallel import mesh
from pqdet_tpu_torch.train.step import (make_optimizer, make_qat_train_step, make_train_step,
                                        sparse_bn_gamma_ids, tree_leaves)
from pqdet_tpu_torch.zoo import CfgBuilder

ND, NS = 2, 2
B, SIZE, MAX_GT, STEPS = 4, 128, 16, 3
LR, WD, CLIP, SPARSE = 1e-3, 0.0, 1.0, 0.01
ANCHORS = np.array(Config().model.anchors, np.float32)
OP_SHAPE = (B, 32, 16, 6)


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
    """A 3x3 stride-1 conv, 3x3 stride-2 convs, a shortcut, an SE (global
    avgpool, two 1x1 convs, scale_channels), a size-5 stride-1 maxpool, an
    upsample routed beside a tap, and three heads at strides 32, 16, 8."""
    b = CfgBuilder()
    b.conv(8, size=3, stride=2)
    b.conv(8, size=3, stride=1)
    b.conv(16, size=3, stride=2)
    t = b.conv(16, size=3, stride=2)
    b.conv(16, size=1)
    t8 = b.shortcut(t)
    x16 = b.conv(24, size=3, stride=2)
    b.avgpool()
    b.conv(8, size=1, bn=False, activation='relu')
    b.conv(24, size=1, bn=False, activation='logistic')
    t16 = b.scale_channels(x16)
    b.conv(32, size=3, stride=2)
    t32 = b.maxpool(5, 1)
    b.conv(75, size=1, bn=False, activation='linear')
    b.yolo(20)
    b.route(t32)
    b.conv(16, size=1)
    b.upsample(2)
    b.route([-1, t16])
    b.conv(75, size=1, bn=False, activation='linear')
    b.yolo(20)
    b.route(t8)
    b.conv(75, size=1, bn=False, activation='linear')
    b.yolo(20)
    return b.text()


def _batch(seed, size=SIZE):
    """A global batch of B uint8 images and their padded GT boxes."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((B, MAX_GT, 6), np.float32)
    for i in range(B):
        n = rng.randint(3, MAX_GT + 1)
        cxy = rng.rand(n, 2) * (size - 8) + 4
        wh = rng.rand(n, 2) * 60 + 4
        gt[i, :n] = np.concatenate([cxy - wh / 2, cxy + wh / 2, rng.randint(0, 20, (n, 1)),
                                    rng.rand(n, 1) * 0.5 + 0.5], 1)
    return {'image': rng.randint(0, 256, (B, size, size, 3)).astype(np.uint8), 'gt': gt}


def _data_rows(batch, d):
    """Data shard d's rows of a global batch, at full height."""
    lb = B // ND
    return {k: torch.from_numpy(v[d * lb:(d + 1) * lb].copy()) for k, v in batch.items()}


# ------------------------------------------------------------ op kinds

def _op_params():
    g = torch.Generator().manual_seed(11)
    c = OP_SHAPE[-1]
    return {'w3': torch.randn(8, c, 3, 3, generator=g) * 0.3,
            'w1': torch.randn(8, c, 1, 1, generator=g) * 0.3,
            'wdw': torch.randn(c, 1, 3, 3, generator=g) * 0.3,
            'b': torch.randn(8, generator=g), 'bdw': torch.randn(c, generator=g),
            'gamma': torch.rand(c, generator=g) + 0.5, 'beta': torch.randn(c, generator=g),
            'head': torch.randn(3 * 7, c, 1, 1, generator=g) * 0.3}


def _op(name, x, p, spatial, group):
    """Op kind ``name`` on NHWC ``x`` (a band under ``spatial``)."""
    if name == 'conv3x3s1':
        return L.conv2d(x, p['w3'], p['b'], 1, 1, spatial=spatial)
    if name == 'conv3x3s2':
        return L.conv2d(x, p['w3'], p['b'], 2, 1, spatial=spatial)
    if name == 'conv1x1':
        return L.conv2d(x, p['w1'], p['b'], 1, 0, spatial=spatial)
    if name == 'dw3x3s2':
        return L.conv2d(x, p['wdw'], p['bdw'], 2, 1, groups=x.shape[-1], spatial=spatial)
    if name == 'maxpool5s1':
        return L.max_pool(x, 5, 1, 2, spatial=spatial)
    if name == 'maxpool3s2':
        return L.max_pool(x, 3, 2, 1, spatial=spatial)
    if name == 'avgpool':
        return L.adaptive_avg_pool(x, 1, 1, spatial=spatial)
    if name == 'upsample':
        return L.upsample_nearest(x, 2)
    if name == 'bn':
        state = {'mean': torch.zeros(x.shape[-1]), 'var': torch.ones(x.shape[-1])}
        y, new = L.batch_norm(x, {'gamma': p['gamma'], 'beta': p['beta']}, state, True,
                              group, spatial)
        return y + 0.0 * (new['mean'].sum() + new['var'].sum())
    if name == 'decode':
        raw = L.conv2d(x, p['head'], None, 1, 0)
        off = spatial.offset(x.shape[1]) if spatial is not None else 0
        return decode(raw, 2, 8, row_offset=off)
    raise KeyError(name)


OPS = ('conv3x3s1', 'conv3x3s2', 'conv1x1', 'dw3x3s2', 'maxpool5s1', 'maxpool3s2', 'avgpool',
       'upsample', 'bn', 'decode')
REPLICATED = ('avgpool',)


def _op_case(name, spatial=None, group=None):
    """(y, dx, param grads) of op ``name`` on the seeded input and
    cotangent: the whole tensors, or this rank's rows and band of them
    (a replicated output takes 1/n_space of the cotangent on each band,
    whose sum is the whole cotangent)."""
    g = torch.Generator().manual_seed(5)
    x = torch.randn(OP_SHAPE, generator=g) * 2 + 0.5
    p = {k: v.clone().requires_grad_(True) for k, v in _op_params().items()}
    y_shape = _op(name, x, {k: v.detach() for k, v in p.items()}, None, None).shape
    dy = torch.randn(y_shape, generator=g)
    if spatial is not None:
        lb, hb = B // spatial.n_data, OP_SHAPE[1] // spatial.n_space
        rows = slice(spatial.d * lb, (spatial.d + 1) * lb)
        x = x[rows, spatial.s * hb:(spatial.s + 1) * hb]
        dy = dy[rows]
        if name in REPLICATED:
            dy = dy / spatial.n_space
        else:
            ho = y_shape[1] // spatial.n_space
            dy = dy[:, spatial.s * ho:(spatial.s + 1) * ho]
    x = x.clone().requires_grad_(True)
    y = _op(name, x, p, spatial, group)
    (y * dy).sum().backward()
    return y.detach(), x.grad, {k: v.grad for k, v in p.items() if v.grad is not None}


# ---------------------------------------------------------------- steps

def _flat(tree):
    return torch.cat([t.reshape(-1).float() for t in tree_leaves(tree)])


def _labels():
    return label_assigner_from_config(Config(), device='cpu')


def _steps(net, params, state, spatial=None, n=STEPS, size=SIZE, **kw):
    """``n`` steps of the port's step (sparse-L1, clip) on the global
    batches at ``size``, or on this rank's data rows of them with
    ``spatial``; the flat params, flat state, Adam's moments and the
    metrics after each."""
    opt = make_optimizer(schedule, weight_decay=WD, grad_clip=CLIP)
    step = make_train_step(net, opt, sparse_ratio=SPARSE, sparse_ids=sparse_bn_gamma_ids(net),
                           label_fn=_labels(), spatial=spatial, **kw)
    p, s, o = params, state, opt.init(params)
    out = []
    for k in range(n):
        b = _batch(k, size)
        b = {key: torch.from_numpy(v) for key, v in b.items()} if spatial is None \
            else _data_rows(b, spatial.d)
        p, s, o, m = step(p, s, o, b)
        out.append({'params': _flat(p), 'state': _flat(s), 'opt': torch.cat([o['mu'], o['nu']]),
                    'metrics': m})
    return out


def _qat_step(qnet, qp, qs, phase, spatial=None):
    """The new observers of one QAT step of phase (observing, bn_frozen)."""
    opt = make_optimizer(schedule, weight_decay=WD, grad_clip=CLIP)
    step = make_qat_train_step(qnet, opt, observing=phase[0], bn_frozen=phase[1],
                               label_fn=_labels(), spatial=spatial)
    b = _batch(0)
    b = {k: torch.from_numpy(v) for k, v in b.items()} if spatial is None \
        else _data_rows(b, spatial.d)
    return step(qp, qs, opt.init(qp), b)[1]['quant']


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ''


# ------------------------------------------------------------- the ranks

def _trainer_opts(root, size=64):
    return ['dataset.train_txt_file', f'{root}/list.txt', 'dataset.eval_txt_file',
            f'{root}/list.txt', 'dataset.classes', '[cat, dog, bird]',
            'model.cfg_path', f'{root}/tiny.cfg', 'model.max_gt_boxes', '8',
            'train.batch_size', str(B), 'train.input_sizes', f'[{size}]',
            'train.max_epochs', '1', 'train.warmup_epochs', '1', 'eval.after', '0',
            'eval.batch_size', '2', 'eval.input_size', str(size), 'eval.max_detections', '32',
            'weight.dir', f'{root}/weights', 'system.num_workers', '1',
            'system.compute_dtype', 'float32', 'train.spatial', str(NS),
            'system.data_devices', str(ND * NS)]


def _rank_trainer(dev, root, res):
    """One epoch of a spatial Trainer (eval after it), its evals and saves
    recorded."""
    from pqdet_tpu_torch.train.trainer import Trainer
    calls = []

    class Recording(Trainer):
        def evaluate(self):
            calls.append('evaluate')
            return super().evaluate()

        def save(self, epoch):
            calls.append(f'save {epoch}')
            return super().save(epoch)

    t = Recording(load_config(opts=_trainer_opts(root)), device=dev)
    t.run()
    res['trainer'] = {'calls': calls, 'step': t.global_step, 'params': _flat(t.params),
                      'state': _flat(t.state), 'local_batch': t.train_data.local_batch_size,
                      'mesh': (t._spatial.n_data, t._spatial.n_space, t._spatial.d,
                               t._spatial.s), 'AP': None if t.AP is None else t.AP.AP}


def _rank_work(dev, net_cfg, params, state, root):
    """Everything the ranks check, written to ``root/rank<r>.pt``."""
    ctx = mesh.make_mesh_2d(ND, NS)
    r = mesh.rank()
    res = {'rank': r, 'mesh': (ctx.d, ctx.s), 'world': mesh.world()}
    res['ops'] = {name: _op_case(name, ctx, ctx.world) for name in OPS}
    net = DetectionNetwork.from_cfg(net_cfg)
    res['steps'] = _steps(net, params, state, ctx)
    res['remat'] = _steps(net, params, state, ctx, n=1, remat=2)[0]
    res['s2d'] = _steps(net, params, state, ctx, n=1, s2d_stem=2)[0]
    qnet = DetectionNetwork.from_cfg(net_cfg, quant=True)
    qp, qs = prepare_qat_state(qnet, params, state)
    res['qat'] = {phase: _qat_step(qnet, qp, qs, phase, ctx)
                  for phase in ((True, False), (True, True))}
    x = torch.zeros(1, 2, 8, 4)
    res['deep_halo'] = _error(lambda: L.max_pool(x, 13, 1, 6, spatial=ctx, what='maxpool 9'))
    res['uneven'] = _steps(net, params, state, ctx, n=1, size=96)[0]
    res['bad_height'] = _error(lambda: make_train_step(
        net, make_optimizer(schedule), label_fn=_labels(), spatial=ctx)(
            params, state, make_optimizer(schedule).init(params),
            _data_rows(_batch(0, size=80), ctx.d)))
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
    """The four ranks' results (one spawn), and the fixture directory."""
    from test_data import _write_voc_fixture
    from test_e2e import TINY_DET
    text, *_, tp, ts = model
    root = str(tmp_path_factory.mktemp('spatial'))
    txt = _write_voc_fixture(root, n=8)
    os.replace(txt, os.path.join(root, 'list.txt'))
    with open(os.path.join(root, 'tiny.cfg'), 'w') as fw:
        fw.write(TINY_DET)
    mesh.launch(_rank_work, ND * NS, 'cpu', 'gloo', (text, tp, ts, root), timeout_s=300)
    return [torch.load(os.path.join(root, f'rank{r}.pt'), weights_only=False)
            for r in range(ND * NS)], root


@pytest.mark.parametrize('name', OPS)
def test_op_bands_equal_whole_op(ranks, name):
    """Each op kind on the bands, forward and backward, against the op on
    the whole tensor: each rank's output rows and input grad rows, and the
    parameter grads summed over the ranks, within f32 rounding (the max
    pool's and upsample's outputs and upsample's grads exactly)."""
    rs, _ = ranks
    y, dx, dp = _op_case(name)
    lb = B // ND
    exact = name in ('maxpool5s1', 'maxpool3s2', 'upsample')
    for res in rs:
        d, s = res['mesh']
        yb, dxb, _ = res['ops'][name]
        rows = slice(d * lb, (d + 1) * lb)
        hb, ho = OP_SHAPE[1] // NS, y.shape[1] // NS
        want_y = y[rows] if name in REPLICATED else y[rows, s * ho:(s + 1) * ho]
        want_dx = dx[rows, s * hb:(s + 1) * hb]
        if exact:
            assert torch.equal(yb, want_y), (name, d, s)
        else:
            torch.testing.assert_close(yb, want_y, rtol=1e-5,
                                       atol=1e-5 * float(want_y.abs().max()))
        tol = 0.0 if name == 'upsample' else 1e-5 * float(want_dx.abs().max())
        torch.testing.assert_close(dxb, want_dx, rtol=0.0 if name == 'upsample' else 1e-5,
                                   atol=tol, msg=f'{name} dx of rank {d, s}')
    for k, g in dp.items():
        got = sum(res['ops'][name][2][k] for res in rs)
        torch.testing.assert_close(got, g, rtol=1e-5, atol=1e-5 * float(g.abs().max()),
                                   msg=f'{name} grad of {k}')


def _jax_steps(model, spatial):
    """STEPS jitted JAX steps, unsharded or on JAX's 2 x 2 mesh (sparse-L1,
    clip); the first loss and the params after the last."""
    import jax
    import jax.numpy as jnp
    from pqdet_tpu.ops.labels import assign_labels_device as jax_assign
    from pqdet_tpu.parallel.mesh import make_mesh_2d, replicated, spatial_batch_shardings
    from pqdet_tpu.train.step import jit_train_step
    from pqdet_tpu.train.step import make_optimizer as jax_make_optimizer
    from pqdet_tpu.train.step import make_train_step as jax_make_train_step
    from pqdet_tpu.train.step import sparse_bn_gamma_ids as jax_sparse_ids
    _, jnet, params, state, *_ = model
    opt = jax_make_optimizer(schedule, weight_decay=WD, grad_clip=CLIP)
    step = jax_make_train_step(
        jnet, opt, sparse_ratio=SPARSE, sparse_ids=jax_sparse_ids(jnet),
        label_fn=lambda gt, size: jax_assign(gt, size, [8, 16, 32], ANCHORS, 20))
    p, s, o = jax.device_get((params, state, opt.init(params)))
    if spatial:
        m = make_mesh_2d(ND, NS)
        sh = spatial_batch_shardings(m)
        step = jit_train_step(step, m, batch_shardings=sh)
        p, s, o = jax.device_put((p, s, o), replicated(m))
    else:
        step = jax.jit(step)
    losses = []
    for k in range(STEPS):
        b = jax.tree.map(jnp.asarray, _batch(k))
        if spatial:
            b = jax.tree.map(lambda x, h: jax.device_put(x, h), b, sh)
        p, s, o, met = step(p, s, o, b, jax.random.PRNGKey(k))
        losses.append(float(met['loss']))
    return losses, jax.device_get(p), jax.device_get(s)


def test_step_ranks_identical_and_within_jax_drift(model, ranks):
    """After each of 3 spatial steps (sparse-L1 and a binding clip on) the
    four ranks' params, BN state, Adam moments and metrics are identical
    bit for bit; the first loss is within 1e-4 of JAX's unsharded step on
    the same batch and weights, each step's loss parts within 1e-4 of the
    port's one-process step, and the params after 3 steps within 2x JAX's
    own distance between its unsharded and its 2 x 2 mesh step."""
    from pqdet_tpu_torch.bridge import from_jax_params
    rs, _ = ranks
    *_, net, tp, ts = model
    r0 = rs[0]
    for res in rs[1:]:
        for k in range(STEPS):
            for key in ('params', 'state', 'opt'):
                assert torch.equal(res['steps'][k][key], r0['steps'][k][key]), (k, key)
            assert all(torch.equal(res['steps'][k]['metrics'][n], r0['steps'][k]['metrics'][n])
                       for n in r0['steps'][k]['metrics'])
    one = _steps(net, tp, ts)
    for k in range(STEPS):
        for name in ('loss', 'giou_loss', 'conf_loss', 'class_loss', 'loss_per_branch'):
            torch.testing.assert_close(r0['steps'][k]['metrics'][name], one[k]['metrics'][name],
                                       rtol=1e-4, atol=0.0, msg=f'step {k} {name}')
    (l1, p1, s1), (l2, p2, _) = _jax_steps(model, False), _jax_steps(model, True)
    first = float(r0['steps'][0]['metrics']['loss'])
    assert abs(first - l1[0]) <= 1e-4 * abs(l1[0]), (first, l1[0])
    assert abs(l2[0] - l1[0]) <= 1e-3 * abs(l1[0])
    f1 = _flat(from_jax_params(p1, s1, net.graph, device='cpu')[0])
    f2 = _flat(from_jax_params(p2, s1, net.graph, device='cpu')[0])
    gap = (r0['steps'][-1]['params'] - f1).norm().item()
    drift = (f1 - f2).norm().item()
    port = (one[-1]['params'] - f1).norm().item()
    bands = (r0['steps'][-1]['params'] - one[-1]['params']).norm().item()
    print(f'after {STEPS} steps: the 2x2 ranks {gap:.4g} from JAX unsharded; JAX 2x2 mesh '
          f'{drift:.4g} from it (losses {l1} unsharded, {l2} 2x2); the port in one process '
          f'{port:.4g} from it, the ranks {bands:.4g} from the port in one process')
    assert gap <= 2 * drift
    # and, much tighter than JAX's own spatial drift: the bands sit as close
    # to one process as one process sits to JAX
    assert bands <= 2 * port


def test_remat_and_s2d_steps(model, ranks):
    """A spatial step with ``remat_segments`` 2 (the segments' recompute
    runs the halo exchanges again, in the same order on every rank) equals
    the spatial step without it; a spatial step with the s2d stem (its row
    padding a halo) gives the one-process s2d step's loss parts within
    1e-4; each is identical on every rank."""
    rs, _ = ranks
    *_, net, tp, ts = model
    for key in ('remat', 's2d'):
        for res in rs[1:]:
            assert torch.equal(res[key]['params'], rs[0][key]['params']), key
    rm, plain = rs[0]['remat'], rs[0]['steps'][0]
    for name in plain['metrics']:
        torch.testing.assert_close(rm['metrics'][name], plain['metrics'][name], rtol=1e-6,
                                   atol=0.0)
    torch.testing.assert_close(rm['params'], plain['params'], rtol=0.0, atol=1e-7)
    one = _steps(net, tp, ts, n=1, s2d_stem=2)[0]
    for name in ('loss', 'giou_loss', 'conf_loss', 'class_loss', 'loss_per_branch'):
        torch.testing.assert_close(rs[0]['s2d']['metrics'][name], one['metrics'][name],
                                   rtol=1e-4, atol=0.0, msg=name)


def test_qat_observers_see_the_whole_image(model, ranks):
    """The QAT step's new observers are identical on the four ranks and
    equal the one-process step's: the input's exactly; with BN frozen every
    edge within 1e-6 of its range (the SE's band sums round apart from one
    mean); with BN on batch statistics within two codes of an 8-bit edge,
    2/255 of the range. There the bands' convs and BN sums round a last
    bit apart from the whole image's (1e-7 at the first edge), and a value
    that lands on the other side of a fake-quant rounding boundary moves
    every later edge by about one code of its input, which no reduction
    order avoids; a lost band or a local min/max would be off by far more
    (the observers see only half the image's rows)."""
    rs, _ = ranks
    text, *_, tp, ts = model
    qnet = DetectionNetwork.from_cfg(text, quant=True)
    qp, qs = prepare_qat_state(qnet, tp, ts)
    for phase in ((True, False), (True, True)):
        one = _qat_step(qnet, qp, qs, phase)
        assert sorted(rs[0]['qat'][phase]) == sorted(one) and len(one) > 10
        for key in one:
            for f in ('min', 'max', 'initialized'):
                for res in rs[1:]:
                    assert torch.equal(res['qat'][phase][key][f], rs[0]['qat'][phase][key][f])
                a = rs[0]['qat'][phase][key][f]
                if key == 'input' or f == 'initialized':
                    assert torch.equal(a, one[key][f]), (phase, key, f)
                else:
                    span = float(one[key]['max'] - one[key]['min'])
                    tol = 1e-6 if phase[1] else 2 / 255
                    assert abs(float(a - one[key][f])) <= tol * span, (phase, key, f)


def test_spatial_errors_on_the_ranks(model, ranks):
    """A halo deeper than a band raises naming the layer and the band
    height; a step on an input height the total stride does not divide (80
    px at total stride 32) raises, as the whole-image step cannot label
    it; a step on an input height the bands do not divide (96 px: 3
    stride-32 rows on 2 bands, walked padded to 128) is identical on every
    rank and gives the one-process step's loss parts within 1e-4, its BN
    state within 1e-4 and its params within 1e-3 of the step's movement
    (L2): the padding adds nothing to BN, the squeeze, the max pool or the
    loss."""
    rs, _ = ranks
    *_, net, tp, ts = model
    for res in rs:
        assert 'maxpool 9' in res['deep_halo'] and 'band of 2 rows' in res['deep_halo']
        assert 'multiple of the graph\'s total stride 32' in res['bad_height'] \
            and '80' in res['bad_height']
        assert torch.equal(res['uneven']['params'], rs[0]['uneven']['params'])
    one = _steps(net, tp, ts, n=1, size=96)[0]
    for name in ('loss', 'giou_loss', 'conf_loss', 'class_loss', 'loss_per_branch'):
        torch.testing.assert_close(rs[0]['uneven']['metrics'][name], one['metrics'][name],
                                   rtol=1e-4, atol=0.0, msg=name)
    torch.testing.assert_close(rs[0]['uneven']['state'], one['state'], rtol=1e-4, atol=1e-5)
    start = _flat(tp)
    moved = (one['params'] - start).norm().item()
    gap = (rs[0]['uneven']['params'] - one['params']).norm().item()
    assert gap <= 1e-3 * moved, (gap, moved)


def test_trainer_spatial_ranks(ranks):
    """A Trainer with ``train.spatial 2`` on 4 ranks: a 2 x 2 mesh, each
    rank loading its data shard's 2 images; rank 0 alone evaluates (whole
    images) and writes the checkpoint, which the JAX package reads; every
    rank ends with the same params and BN state."""
    from pqdet_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
    rs, root = ranks
    t0 = rs[0]['trainer']
    assert t0['calls'] == ['evaluate', 'save 0'] and 0.0 <= t0['AP'] <= 1.0
    for res in rs:
        t = res['trainer']
        assert t['mesh'] == (ND, NS) + res['mesh'] and t['local_batch'] == B // ND
        assert t['step'] == 2 and torch.equal(t['params'], t0['params'])
        assert torch.equal(t['state'], t0['state'])
        if res['rank']:
            assert t['calls'] == []
    wdir = os.path.join(root, 'weights', 'VOC')
    names = os.listdir(wdir)
    assert len(names) == 1 and names[0].startswith('model-0-')
    assert jax_load_checkpoint(os.path.join(wdir, names[0]))['step'] == 2


def test_trainer_validates_spatial_config(tmp_path):
    """JAX's ``test_trainer_validates_spatial_config`` in the port, raised
    at construction: ``train.unroll_steps`` 2 (JAX's message), host labels,
    the device corpus, an input height the total stride does not divide;
    and no process group at all (no fallback to one process), which is also
    all that an input height the bands do not divide (320 on 4 bands of
    stride 32) meets now: it is walked padded."""
    from pqdet_tpu_torch.train.trainer import Trainer
    base = ['dataset.classes', '[a,b,c]', 'model.cfg_path', 'mobilenetv2-fpn',
            'train.spatial', '4', 'dataset.train_txt_file', '/nonexistent',
            'train.input_sizes', '[512]']
    for extra, match in ((['train.unroll_steps', '2'], 'train.spatial excludes unroll_steps'),
                         (['system.label_assign', 'host'], 'label_assign'),
                         (['augment.device', 'on', 'dataset.device_cache', 'on'],
                          'device_cache'),
                         (['train.input_sizes', '[336]'], 'not a multiple of the graph'),
                         (['train.input_sizes', '[320]'], 'needs a process group of 4 ranks'),
                         ([], 'needs a process group of 4 ranks')):
        with pytest.raises(ValueError, match=match):
            Trainer(load_config(opts=base + extra), device='cpu')


def test_mesh_layout_and_guards():
    """``mesh_shape`` and ``resolve_world`` take JAX's device budget
    (``system.data_devices`` is the total, the data axis fits the batch);
    ``make_mesh_2d`` raises without a process group; ``spatial_batch_shardings``
    gives rank (d, s)'s data rows and band rows; ``SpatialCtx.padded_height``
    rounds a height up to the bands x the total stride and refuses one the
    stride does not divide."""
    assert mesh.mesh_shape(0, 12, 2, 8) == (4, 2)      # JAX: avail 8 // 2, fit to 12
    assert mesh.mesh_shape(4, 4, 2, 1) == (2, 2)
    assert mesh.mesh_shape(0, 4, 2, 1) == (1, 2)
    assert mesh.mesh_shape(3, 12, 0, 1) == (3, 1)
    assert mesh.resolve_world(4, 4, 'cpu', 2) == 4 and mesh.resolve_world(0, 4, 'cpu', 2) == 2
    assert mesh.resolve_world(2, 4, 'cpu') == 2
    with pytest.raises(ValueError, match='needs a process group of 4 ranks'):
        mesh.make_mesh_2d(2, 2)
    ctx = mesh.SpatialCtx(2, 2, 1, 0, None, None, None)
    sh = mesh.spatial_batch_shardings(ctx, 8, 64)
    assert sh == {'image': (slice(4, 8), slice(0, 32)), 'gt': (slice(4, 8),)}
    assert ctx.padded_height(128, 32) == 128 and ctx.padded_height(96, 32) == 128
    assert ctx.padded_height(416, 32) == 448 and ctx.padded_height(480, 32) == 512
    with pytest.raises(ValueError, match='total stride 32'):
        ctx.padded_height(80, 32)
