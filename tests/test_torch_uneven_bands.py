"""Uneven bands of spatial partitioning (``train.spatial``) on the CPU: input
heights that the bands x the total stride do not divide, which the step
walks padded (``parallel/halo.py``), against JAX's unsharded step and the
port's one process. One spawn of eight gloo ranks (``ranks``, module
scope) runs both meshes:

- JAX's own oracle, ``tests/test_spatial.py::test_spatial_step_loss_matches_unsharded``:
  a (2 data x 4 space) mesh at 64 px, two stride-32 rows over four bands
  (two bands hold padding only), JAX's tiny net, batch and schedule;
- a (4 data x 2 space) mesh at 96 px, three stride-32 rows over two bands,
  on ``tests/test_torch_spatial.py``'s net (an SE with its band-sum
  pool, a max pool, a shortcut, an upsample and a route), three steps
  with sparse-L1 and a binding clip.

The rank side of this module imports no JAX.
"""

import os

import numpy as np
import pytest
import torch

from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.ops.labels import assign_labels_device
from pqdet_tpu_torch.parallel import mesh
from pqdet_tpu_torch.train.schedule import cosine_warmup
from pqdet_tpu_torch.train.step import (make_optimizer, make_train_step, sparse_bn_gamma_ids,
                                        tree_leaves)
from pqdet_tpu_torch.zoo import CfgBuilder
from test_torch_spatial import CLIP, SPARSE, WD, _batch, _labels, _net_cfg, schedule

WORLD = 8
# (e): JAX's test_spatial oracle
E_MESH, E_SIZE = (2, 4), 64
E_STRIDES = np.array([8, 16, 32])
E_ANCHORS = np.array([[10, 13], [16, 30], [33, 23], [30, 61], [62, 45], [59, 119], [116, 90],
                      [156, 198], [373, 326]], np.float32)
# (f): three stride-32 rows on two bands
F_MESH, F_SIZE, F_STEPS = (4, 2), 96, 3


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


def _tiny_cfg():
    """JAX's ``tests/test_spatial.py::_tiny_cfg``."""
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


def _e_batch(seed):
    """JAX's ``tests/test_spatial.py::_batch`` (4 images at 64 px)."""
    rng = np.random.default_rng(seed)
    imgs = (rng.random((4, E_SIZE, E_SIZE, 3)) * 255).astype(np.uint8)
    gt = np.zeros((4, 8, 6), np.float32)
    gt[:, 0] = [6, 6, 30, 30, 1, 1.0]
    gt[:, 1] = [34, 20, 60, 50, 2, 1.0]
    return {'image': imgs, 'gt': gt}


def _e_label_fn(gt, size):
    return assign_labels_device(gt, size, E_STRIDES.tolist(), E_ANCHORS, 4)


def _rows(batch, spatial):
    """This rank's data shard's rows of a global numpy batch (the whole
    batch without ``spatial``), at full height."""
    if spatial is None:
        return {k: torch.from_numpy(v) for k, v in batch.items()}
    lb = len(batch['image']) // spatial.n_data
    return {k: torch.from_numpy(v[spatial.d * lb:(spatial.d + 1) * lb].copy())
            for k, v in batch.items()}


def _flat(tree):
    return torch.cat([t.reshape(-1).float() for t in tree_leaves(tree)])


def _e_steps(params, state, spatial=None):
    """JAX's two steps of the oracle: the losses."""
    net = DetectionNetwork.from_cfg(_tiny_cfg())
    opt = make_optimizer(cosine_warmup(1e-3, 1e-6, 0, 1000))
    step = make_train_step(net, opt, label_fn=_e_label_fn, spatial=spatial)
    p, s, o = params, state, opt.init(params)
    losses = []
    for seed in (0, 1):
        p, s, o, m = step(p, s, o, _rows(_e_batch(seed), spatial))
        losses.append(float(m['loss']))
    return losses


def _f_steps(params, state, spatial=None, reverse=False):
    """F_STEPS steps of the port's step (sparse-L1, clip) at F_SIZE: the
    flat params and state and the metrics after each."""
    net = DetectionNetwork.from_cfg(_net_cfg())
    opt = make_optimizer(schedule, weight_decay=WD, grad_clip=CLIP)
    step = make_train_step(net, opt, sparse_ratio=SPARSE, sparse_ids=sparse_bn_gamma_ids(net),
                           label_fn=_labels(), spatial=spatial)
    p, s, o = params, state, opt.init(params)
    out = []
    for k in range(F_STEPS):
        b = _batch(k, F_SIZE)
        if reverse:
            b = {key: v[::-1].copy() for key, v in b.items()}
        p, s, o, m = step(p, s, o, _rows(b, spatial))
        out.append({'params': _flat(p), 'state': _flat(s), 'metrics': m})
    return out


def _rank_work(dev, e_model, f_model, root):
    r = mesh.rank()
    e_ctx = mesh.make_mesh_2d(*E_MESH)
    f_ctx = mesh.make_mesh_2d(*F_MESH)
    res = {'e_mesh': (e_ctx.d, e_ctx.s), 'f_mesh': (f_ctx.d, f_ctx.s),
           'e': _e_steps(*e_model, e_ctx), 'f': _f_steps(*f_model, f_ctx)}
    torch.save(res, os.path.join(root, f'rank{r}.pt'))


# ------------------------------------------------------------- the parent

@pytest.fixture(scope='module')
def models():
    """JAX's init of both nets, and the port's copies of the weights."""
    import jax
    from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
    from pqdet_tpu_torch.bridge import from_jax_params
    out = {}
    for name, text, key in (('e', _tiny_cfg(), 0), ('f', _net_cfg(), 1)):
        jnet = JaxNetwork.from_cfg(text)
        params, state = jnet.init(jax.random.PRNGKey(key))
        net = DetectionNetwork.from_cfg(text)
        out[name] = (jnet, params, state, net,
                     from_jax_params(params, state, net.graph, device='cpu'))
    return out


@pytest.fixture(scope='module')
def ranks(models, tmp_path_factory):
    root = str(tmp_path_factory.mktemp('uneven'))
    mesh.launch(_rank_work, WORLD, 'cpu', 'gloo', (models['e'][-1], models['f'][-1], root),
                timeout_s=300)
    return [torch.load(os.path.join(root, f'rank{r}.pt'), weights_only=False)
            for r in range(WORLD)]


def test_jax_spatial_oracle_at_64px(models, ranks):
    """JAX's 2 data x 4 space step at 64 px (two stride-32 rows over four
    bands) as eight gloo ranks: the loss within JAX's own 1e-3 * max(1,
    |loss|) of JAX's unsharded step on the same batch and weights, within
    1e-5 relative of the port's one process, the same on every rank; a
    second step stays finite."""
    import jax
    import jax.numpy as jnp
    from pqdet_tpu.ops.labels import assign_labels_device as jax_assign
    from pqdet_tpu.train.schedule import cosine_warmup as jax_cosine_warmup
    from pqdet_tpu.train.step import make_optimizer as jax_make_optimizer
    from pqdet_tpu.train.step import make_train_step as jax_make_train_step
    jnet, params, state, _, (tp, ts) = models['e']
    opt = jax_make_optimizer(jax_cosine_warmup(1e-3, 1e-6, 0, 1000))
    step = jax_make_train_step(jnet, opt, label_fn=lambda g, size: jax_assign(
        g, size, E_STRIDES, E_ANCHORS, 4))
    _, _, _, m = jax.jit(step)(params, state, opt.init(params),
                               jax.tree.map(jnp.asarray, _e_batch(0)), jax.random.PRNGKey(5))
    loss_jax = float(m['loss'])
    one = _e_steps(tp, ts)
    assert [r['e_mesh'] for r in ranks] == [divmod(r, E_MESH[1]) for r in range(WORLD)]
    bands = ranks[0]['e']
    assert all(r['e'] == bands for r in ranks)
    print(f'2x4 bands at 64 px: loss {bands[0]!r}; JAX unsharded {loss_jax!r}; the port in one '
          f'process {one[0]!r}')
    assert abs(bands[0] - loss_jax) <= 1e-3 * max(1.0, abs(loss_jax))
    assert abs(bands[0] - one[0]) <= 1e-5 * abs(one[0])
    assert np.isfinite(bands[1]) and abs(bands[1] - one[1]) <= 1e-4 * abs(one[1])


def test_odd_stride32_rows_on_two_bands(models, ranks):
    """4 data x 2 space at 96 px (three stride-32 rows on two bands, the
    second band's last row padding; the SE's band sums, the max pool's
    halo, BN's moments and the loss see real rows only): identical on every
    rank, the first loss within 1e-5 of the port's one process, each
    step's loss parts within 1e-4, and the params after 3 steps within 2x
    JAX's own drift between its unsharded steps on the batches and on the
    batches reversed."""
    import jax
    import jax.numpy as jnp
    from pqdet_tpu.ops.labels import assign_labels_device as jax_assign
    from pqdet_tpu.train.step import make_optimizer as jax_make_optimizer
    from pqdet_tpu.train.step import make_train_step as jax_make_train_step
    from pqdet_tpu.train.step import sparse_bn_gamma_ids as jax_sparse_ids
    from pqdet_tpu_torch.bridge import from_jax_params
    from test_torch_spatial import ANCHORS
    jnet, params, state, net, (tp, ts) = models['f']
    r0 = ranks[0]['f']
    for r in ranks[1:]:
        for k in range(F_STEPS):
            assert torch.equal(r['f'][k]['params'], r0[k]['params'])
            assert torch.equal(r['f'][k]['state'], r0[k]['state'])
    one = _f_steps(tp, ts)
    first = float(r0[0]['metrics']['loss'])
    assert abs(first - float(one[0]['metrics']['loss'])) <= 1e-5 * abs(first)
    for k in range(F_STEPS):
        for name in ('loss', 'giou_loss', 'conf_loss', 'class_loss', 'loss_per_branch'):
            torch.testing.assert_close(r0[k]['metrics'][name], one[k]['metrics'][name],
                                       rtol=1e-4, atol=0.0, msg=f'step {k} {name}')
    opt = jax_make_optimizer(schedule, weight_decay=WD, grad_clip=CLIP)
    step = jax.jit(jax_make_train_step(
        jnet, opt, sparse_ratio=SPARSE, sparse_ids=jax_sparse_ids(jnet),
        label_fn=lambda g, size: jax_assign(g, size, [8, 16, 32], ANCHORS, 20)))
    flat = {}
    for name, rev in (('jax', False), ('reversed', True)):
        p, s, o = params, state, opt.init(params)
        for k in range(F_STEPS):
            b = _batch(k, F_SIZE)
            if rev:
                b = {key: v[::-1].copy() for key, v in b.items()}
            p, s, o, _ = step(p, s, o, jax.tree.map(jnp.asarray, b), jax.random.PRNGKey(k))
        flat[name] = _flat(from_jax_params(jax.device_get(p), state, net.graph,
                                           device='cpu')[0])
    drift = (flat['reversed'] - flat['jax']).norm().item()
    gap = (r0[-1]['params'] - one[-1]['params']).norm().item()
    port = (one[-1]['params'] - flat['jax']).norm().item()
    print(f'4x2 bands at 96 px after {F_STEPS} steps: {gap:.4g} (L2) from the port in one '
          f'process; JAX on the reversed batches {drift:.4g} from JAX, the port in one process '
          f'{port:.4g} from JAX')
    assert 0 < drift and gap <= 2 * drift
