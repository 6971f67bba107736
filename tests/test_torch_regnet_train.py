"""The port's train step on grouped convs held to ``jax.jit`` of the JAX
package's ``make_train_step`` step by step (CPU, f32), as
``tests/test_torch_train_parity.py`` holds it on mobilenetv2-fpn: a narrow
RegNetY (group width 8, squeeze-excite, the FPN head of the zoo) at
128x128 and the full-width regnetx-600m-fpn at 64x64, B=4, device labels,
sparse-L1, a binding global-norm clip and weight decay on, the lr of update
k ``LR * (k + 1)``.

JAX trains grouped convs densified (``dense_groups=True``: block-diagonal
dense weights behind an eye mask); the port runs cuDNN's grouped convs.
The two compute the same function with the same gradient, so the same
bounds hold: each step starts both sides from JAX's state after the steps
before it; the loss agrees to 1e-5; grads and params are held to 2x JAX's
own drift on the batch with its images reversed (its sums in another
order), because a walk with batch statistics amplifies the rounding of its
first layers by its last.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree
import torch

from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
from pqdet_tpu.ops.labels import assign_labels_device as jax_assign
from pqdet_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from pqdet_tpu.train.step import make_optimizer as jax_make_optimizer
from pqdet_tpu.train.step import make_train_step as jax_make_train_step
from pqdet_tpu.train.step import sparse_bn_gamma_ids as jax_sparse_ids
from pqdet_tpu.zoo.regnet import _regnet_fpn as jax_regnet_fpn
from pqdet_tpu_torch.bridge import from_jax_params
from pqdet_tpu_torch.config import Config
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.ops.labels import label_assigner_from_config
from pqdet_tpu_torch.train.checkpoint import save_checkpoint
from pqdet_tpu_torch.train.step import (make_optimizer, make_train_step, sparse_bn_gamma_ids,
                                        tree_leaves)
from pqdet_tpu_torch.zoo import get_cfg
from pqdet_tpu_torch.zoo.regnet import _regnet_fpn
from tests.test_torch_train_parity import PARTS, _adam, _flat, _gap

B, MAX_GT, STEPS = 4, 12, 2
LR, WD, CLIP, SPARSE = 1e-3, 1e-3, 1.0, 0.01
ANCHORS = np.array(Config().model.anchors, np.float32)
# a RegNetY of four one-block stages, group width 8, SE at 0.25
NARROW_Y = dict(widths=(16, 32, 48, 64), depths=(1, 1, 1, 1), group_w=8)
MODELS = {'narrow-regnety': lambda: _regnet_fpn(NARROW_Y, 0.25, 20, 'giou', 0.05),
          'regnetx-600m-fpn': lambda: get_cfg('regnetx-600m-fpn')}
# input side of each model's batches: the narrow net at 128 (at 64 its
# stride-32 BN sees 16 samples a channel and JAX's f32 head leaves drift
# from a float64 step far more than JAX's own drift on the reversed batch)
SIZES = {'narrow-regnety': 128, 'regnetx-600m-fpn': 64}


def schedule(k):
    return LR * (k + 1)


def _batch(seed, size):
    """B seeded images at ``size`` and 2 to MAX_GT boxes each, 4 px to 0.6
    of the image a side."""
    rng = np.random.RandomState(seed)
    gt = np.zeros((B, MAX_GT, 6), np.float32)
    for i in range(B):
        n = rng.randint(2, MAX_GT + 1)
        cxy = rng.rand(n, 2) * (size - 8) + 4
        wh = rng.rand(n, 2) * (0.6 * size) + 4
        gt[i, :n] = np.concatenate([cxy - wh / 2, cxy + wh / 2, rng.randint(0, 20, (n, 1)),
                                    rng.rand(n, 1) * 0.5 + 0.5], 1)
    return {'image': rng.randint(0, 256, (B, size, size, 3)).astype(np.uint8), 'gt': gt}


def test_narrow_cfg_equals_jax():
    assert MODELS['narrow-regnety']() == jax_regnet_fpn(NARROW_Y, 0.25, 20, 'giou', 0.05)


@pytest.fixture(scope='module', params=sorted(MODELS))
def run(request):
    """Per step k: JAX's step on batch k and on batch k reversed, and the
    port's on batch k, all three from JAX's state after steps 0..k-1
    (effective grads read off each side's new first moment)."""
    cfg = MODELS[request.param]()
    jnet = JaxNetwork.from_cfg(cfg)
    params, state = jnet.init(jax.random.PRNGKey(0))
    net = DetectionNetwork.from_cfg(cfg)
    unravel = ravel_pytree(params)[1]

    def port_flat(v, js):
        return _flat(from_jax_params(jax.device_get(unravel(v)), js, net.graph, device='cpu')[0])

    jopt = jax_make_optimizer(schedule, weight_decay=WD, grad_clip=CLIP)
    jstep = jax.jit(jax_make_train_step(
        jnet, jopt, sparse_ratio=SPARSE, sparse_ids=jax_sparse_ids(jnet),
        label_fn=lambda gt, size: jax_assign(gt, size, [8, 16, 32], ANCHORS, 20)))
    opt = make_optimizer(schedule, weight_decay=WD, grad_clip=CLIP)
    step = make_train_step(net, opt, sparse_ratio=SPARSE, sparse_ids=sparse_bn_gamma_ids(net),
                           label_fn=label_assigner_from_config(Config(), device='cpu'))
    assert sparse_bn_gamma_ids(net) == jax_sparse_ids(jnet)
    jp, js, jo = params, state, jopt.init(params)
    out = []
    for k in range(STEPS):
        b = _batch(10 + k, SIZES[request.param])
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
        res['port'] = {'loss': {n: float(m[n]) for n in PARTS}, 'state': s, 'params': _flat(p),
                       'grad': (o['mu'] - 0.9 * mu0) / 0.1, 'tree': (p, s)}
        res['start'] = _flat(p0)
        out.append(res)
        jp, js, jo = nxt
    return request.param, net, out, [t.numel() for t in tree_leaves(p0)]


@pytest.mark.parametrize('k', range(STEPS))
def test_loss_matches_jax(run, k):
    """The loss of step k+1 within rtol 1e-5 of JAX's; each part within
    rtol 1e-5 or 3x JAX's own gap on the reversed batch."""
    res = run[2][k]
    want = res['jax']['loss']
    np.testing.assert_allclose(res['port']['loss']['loss'], want['loss'], rtol=1e-5)
    for n in PARTS[1:]:
        own = abs(res['reversed']['loss'][n] / want[n] - 1)
        assert abs(res['port']['loss'][n] / want[n] - 1) <= max(1e-5, 3 * own), n


@pytest.mark.parametrize('k', range(STEPS))
def test_bn_state_matches_jax(run, k):
    """The BN running statistics after step k+1: the largest |d| / max(1,
    |s|) over every entry within 1e-5 or 2x JAX's own on the reversed batch,
    whichever is larger (regnetx-600m-fpn's running variances of up to ~30
    move 1.06e-5 between JAX's two orders of the batch; the port's measured
    up to 1.25e-5)."""
    res = run[2][k]
    want = res['jax']['state']
    assert sorted(res['port']['state']) == sorted(want)

    def worst(who):
        got = res[who]['state']
        return max(((got[key][st] - want[key][st]).abs()
                    / want[key][st].abs().clamp_min(1.0)).max().item()
                   for key in want for st in ('mean', 'var'))
    assert worst('port') <= max(1e-5, 2 * worst('reversed')), (worst('port'), worst('reversed'))


@pytest.mark.parametrize('k', range(STEPS))
def test_grads_match_jax(run, k):
    """The effective grads of step k+1: the whole vector's L2 distance from
    JAX's at most 2x JAX's own on the reversed batch, each leaf's at most 5x
    its own plus 1e-4."""
    res, sizes = run[2][k], run[3]
    assert _gap(res, 'port', 'grad') <= 2 * _gap(res, 'reversed', 'grad')
    leaves = {who: torch.split(res[who]['grad'], sizes) for who in ('port', 'reversed', 'jax')}
    for i, w in enumerate(leaves['jax']):
        port = ((leaves['port'][i] - w).norm() / w.norm()).item()
        own = ((leaves['reversed'][i] - w).norm() / w.norm()).item()
        assert port <= 5 * own + 1e-4, (i, port, own)


@pytest.mark.parametrize('k', range(STEPS))
def test_params_match_jax(run, k):
    """The params after update k: the update's L2 distance from JAX's at
    most 2x JAX's own on the reversed batch, and the elements more than
    1e-2 lr from JAX's no more than 2x as many as JAX's own."""
    res = run[2][k]
    lr = schedule(k)
    want = res['jax']['params']
    upd = want - res['start']
    gaps = {who: (res[who]['params'] - want) for who in ('port', 'reversed')}
    assert gaps['port'].norm() <= 2 * gaps['reversed'].norm() + 1e-6 * upd.norm()
    far = {who: int((g.abs() > 1e-2 * lr).sum()) for who, g in gaps.items()}
    assert far['port'] <= 2 * far['reversed'], far


def test_trained_checkpoint_loads_in_jax(run, tmp_path):
    """The port's checkpoint of the trained grouped net is one JAX's codec
    reads: its params equal the port's in JAX's layout (grouped HWIO
    (3, 3, Cin/G, Cout) weights), its cfg text the model's."""
    name, net, out, _ = run
    p, s = out[-1]['port']['tree']
    path = str(tmp_path / 'm.ckpt')
    save_checkpoint(path, net.graph, p, s, step=STEPS, cfg_text=net.graph.cfg_text)
    ck = jax_load_checkpoint(path)
    assert ck['cfg'] == net.graph.cfg_text and ck['step'] == STEPS
    back, _ = from_jax_params(ck['params'], ck['state'], net.graph, device='cpu')
    n_grouped = 0
    for node in net.graph.nodes:
        key = str(node.index)
        if node.kind != 'convolutional':
            continue
        g = node.attrs['groups']
        if g > 1 and node.in_channels // g > 1:
            n_grouped += 1
            assert np.asarray(ck['params'][key]['w']).shape == \
                (3, 3, node.in_channels // g, node.out_channels)
        assert torch.equal(back[key]['w'], p[key]['w']), key
    assert n_grouped >= 4, name
