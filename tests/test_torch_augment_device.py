"""The port's device augmentation (``pqdet_tpu_torch/ops/augment_device.py``)
against the JAX package's (``pqdet_tpu/ops/augment_device.py``) on the CPU,
on the same numpy inputs at 64 px.

JAX draws inside its stages from ``jax.random`` keys; the port takes the
same values as explicit arguments. ``jax_draws`` replays JAX's key schedule
from one ``PRNGKey`` (12 keys; the base chain's 6 from ``keys[:6]``, or
with fresh partners from ``split(keys[11], 6)`` over all 5B rows; mosaic's
permutations and centre from ``keys[6]``, its Bernoulli from ``keys[7]``,
mixup's permutation, ``lam`` and Bernoulli from ``keys[8:11]``) into the
port's ``AugmentDraws``. With those draws each stage and the whole chain,
in-batch and fresh, equal JAX's: images and boxes bit for bit. The warp's
pixels are held to within one level on at most WARP_SHARE of them (its two
matmuls may sum in another order on another library); the share measured
here is 0. The augmented train step is held to JAX's
``make_train_step(augment_fn=...)`` on the shallow net of
``tests/test_torch_train_step.py``, loss to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pqdet_tpu.config import load_config as jax_load_config
from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
from pqdet_tpu.ops import augment_device as jad
from pqdet_tpu.train.step import make_optimizer as jax_make_optimizer
from pqdet_tpu.train.step import make_train_step as jax_make_train_step
from pqdet_tpu_torch.bridge import from_jax_params
from pqdet_tpu_torch.config import Config, load_config
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.ops import augment_device as ad
from pqdet_tpu_torch.ops.labels import label_assigner_from_config
from pqdet_tpu_torch.train.step import (make_optimizer, make_qat_train_step,
                                        make_train_step)
from test_torch_train_step import _jax_label_fn, _shallow_cfg, schedule

S, B, G = 64, 4, 6
WARP_SHARE = 1e-3      # pixels of a warped image allowed one level apart
ALL_ON = dict(hflip_p=0.5, vflip_p=0.5, crop_p=0.75, color_p=0.8, mosaic_p=0.5,
              mixup_p=0.5)


def jax_draws(key, batch, size, partner_rows=0):
    """The values JAX's ``device_augment`` draws from ``key`` for a batch
    of ``batch`` images of ``size``^2 with ``partner_rows`` fresh partner
    rows per sample, as the port's ``AugmentDraws`` (numpy, under jit as in
    the chain). The permutations a fresh chain does not draw are identity."""
    def draw(key):
        keys = jax.random.split(key, 12)
        n = batch * (1 + partner_rows)
        base = jax.random.split(keys[11], 6) if partner_rows else keys[:6]

        def u(k, m):
            return jax.random.uniform(k, (m,))
        kb, kc, ks, ko = jax.random.split(base[4], 4)
        if partner_rows:
            kx, ky = jax.random.split(keys[6])
            perms = jnp.stack([jnp.arange(batch)] * 3)
            mix_perm = jnp.arange(batch)
        else:
            kp, kx, ky = jax.random.split(keys[6], 3)
            perms = jnp.stack([jax.random.permutation(k, batch)
                               for k in jax.random.split(kp, 3)])
            mix_perm = jax.random.permutation(keys[8], batch)
        lo, hi = size // 2, size + size // 2
        return dict(
            hflip=u(base[0], n), vflip=u(base[1], n), crop=u(base[3], n),
            crop_box=jnp.stack([u(k, n) for k in jax.random.split(base[2], 4)]),
            color=u(base[5], n),
            brightness=jax.random.uniform(kb, (n,), minval=ad.BRIGHTNESS[0],
                                          maxval=ad.BRIGHTNESS[1]),
            contrast=jax.random.uniform(kc, (n,), minval=ad.CONTRAST[0],
                                        maxval=ad.CONTRAST[1]),
            saturation=jax.random.uniform(ks, (n,), minval=ad.SATURATION[0],
                                          maxval=ad.SATURATION[1]),
            order=jax.random.randint(ko, (n,), 0, 6),
            mosaic=u(keys[7], batch), mosaic_perm=perms,
            xc=jax.random.randint(kx, (batch,), lo, hi),
            yc=jax.random.randint(ky, (batch,), lo, hi),
            mixup=u(keys[10], batch), mixup_perm=mix_perm,
            lam=jax.random.beta(keys[9], ad.MIXUP_BETA, ad.MIXUP_BETA, (batch,)))
    vals = jax.device_get(jax.jit(draw)(key))
    return ad.AugmentDraws(**{
        k: torch.from_numpy(np.array(v)).long() if k in ad.AugmentDraws.INTS
        else torch.from_numpy(np.array(v)) for k, v in vals.items()})


def _images(rng, n, size=S):
    return rng.integers(0, 256, (n, size, size, 3)).astype(np.uint8)


def _gt(rng, n, g=G, size=S):
    """(n, g, 6) padded boxes: 1-g boxes a row, some small, a weight of 1."""
    out = np.zeros((n, g, 6), np.float32)
    for b in range(n):
        for i in range(rng.integers(1, g + 1)):
            x1, y1 = rng.uniform(0, size - 10, 2)
            w, h = rng.uniform(3, 40, 2)
            out[b, i] = [x1, y1, min(size, x1 + w), min(size, y1 + h), rng.integers(0, 20), 1]
    return out


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_warp_close(got, want, what):
    """Images within one level on at most WARP_SHARE of the pixels; prints
    the share."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    share = float((d > 0).mean())
    print(f'{what}: {share:.3g} of the pixels one level apart (max |d| {d.max()})')
    assert d.max() <= 1 and share <= WARP_SHARE, (what, d.max(), share)


def _stage(name, seed=0):
    """(JAX output, port output, exact) of one stage on seeded inputs."""
    rng = np.random.default_rng(seed)
    img = _images(rng, B).astype(np.float32)
    gt = _gt(rng, B)
    apply_b = np.array([True, True, False, True])
    key = jax.random.PRNGKey(seed)
    if name in ('hflip', 'vflip'):
        fn = getattr(jad, name)
        return jax.jit(fn)(img, gt, apply_b), getattr(ad, name)(_t(img), _t(gt), _t(apply_b)), True
    if name == 'zoom_crop':
        u = np.stack([np.asarray(jax.random.uniform(k, (B,))) for k in jax.random.split(key, 4)])
        return (jax.jit(jad.zoom_crop)(img, gt, key, apply_b),
                ad.zoom_crop(_t(img), _t(gt), _t(u), _t(apply_b)), False)
    if name == 'color_jitter':
        img[:, :16] = img[:, :16, :, :1]          # gray rows: saturation at its ties
        kb, kc, ks, ko = jax.random.split(key, 4)
        args = [jax.random.uniform(kb, (B,), minval=-0.1, maxval=0.1),
                jax.random.uniform(kc, (B,), minval=0.8, maxval=1.2),
                jax.random.uniform(ks, (B,), minval=0.1, maxval=2.0),
                jax.random.randint(ko, (B,), 0, 6)]
        args = [_t(a) for a in args[:3]] + [_t(args[3]).long()]
        return ((jax.jit(jad.color_jitter)(img, key, apply_b), gt),
                (ad.color_jitter(_t(img), *args, _t(apply_b)), _t(gt)), True)
    if name == 'mosaic_place':
        img4 = _images(rng, 4 * B).astype(np.float32).reshape(B, 4, S, S, 3)
        gt4 = _gt(rng, 4 * B).reshape(B, 4, G, 6)
        xc = rng.integers(S // 2, S + S // 2, B)
        yc = np.array([S // 2, S + S // 2 - 1, S, S - 3])   # both ends of the range
        return (jax.jit(jad.mosaic_place)(img4, gt4, xc, yc),
                ad.mosaic_place(_t(img4), _t(gt4), _t(xc), _t(yc)), True)
    if name == 'mosaic':
        kp, kx, ky = jax.random.split(key, 3)
        perms = np.stack([np.asarray(jax.random.permutation(k, B))
                          for k in jax.random.split(kp, 3)])
        xc = np.asarray(jax.random.randint(kx, (B,), S // 2, S + S // 2))
        yc = np.asarray(jax.random.randint(ky, (B,), S // 2, S + S // 2))
        return (jax.jit(jad.mosaic)(img, gt, key, apply_b),
                ad.mosaic(_t(img), _t(gt), _t(perms).long(), _t(xc), _t(yc), _t(apply_b)), True)
    if name == 'mixup':
        pimg, pgt = _images(rng, B).astype(np.float32), _gt(rng, B)
        pgt[0, 2:] = 0                               # empty partner rows keep their weight
        lam = rng.beta(1.5, 1.5, B).astype(np.float32)
        return (jax.jit(jad.mixup)(img, gt, pimg, pgt, lam, apply_b),
                ad.mixup(_t(img), _t(gt), _t(pimg), _t(pgt), _t(lam), _t(apply_b)), True)
    raise KeyError(name)


@pytest.mark.parametrize('name', ['hflip', 'vflip', 'zoom_crop', 'color_jitter',
                                  'mosaic_place', 'mosaic', 'mixup'])
def test_stage_matches_jax(name):
    """Each stage on the draws JAX takes: boxes bit for bit; images bit for
    bit, the zoom's warp within one level on at most WARP_SHARE."""
    (ji, jb), (pi, pb), exact = _stage(name)
    ji, jb = np.asarray(ji), np.asarray(jb)
    assert pi.shape == ji.shape and pb.shape == jb.shape
    np.testing.assert_array_equal(pb.numpy(), jb)
    if exact:
        np.testing.assert_array_equal(pi.numpy(), ji)
    else:
        _assert_warp_close(pi.numpy(), ji, name)


CHAINS = {
    'in_batch': (ALL_ON, 0),
    'fresh': (ALL_ON, 4),
    'fresh_mosaic_only': ({**ALL_ON, 'mixup_p': 0.0}, 3),
    'in_batch_mixup_only': ({**ALL_ON, 'mosaic_p': 0.0, 'color_p': 0.0}, 0),
}


@pytest.mark.parametrize('case', sorted(CHAINS))
def test_device_augment_matches_jax(case):
    """The whole chain (flips, crop, jitter, mosaic, mixup, the weight
    column) from one key, in-batch or with fresh partners (rows [0:3B] to
    mosaic, [3B:4B] to mixup): uint8 images within one level on at most
    WARP_SHARE (the warp), grown boxes bit for bit."""
    probs, partners = CHAINS[case]
    rng = np.random.default_rng(7)
    img, gt = _images(rng, B), _gt(rng, B)
    pimg, pgt = (_images(rng, partners * B), _gt(rng, partners * B)) if partners else (None, None)
    jparams = jad.AugmentParams(**probs)
    key = jax.random.PRNGKey(11)
    if partners:
        ji, jb = jax.jit(lambda *a: jad.device_augment(a[0], a[1], a[2], jparams, a[3], a[4]))(
            img, gt, key, pimg, pgt)
    else:
        ji, jb = jax.jit(lambda *a: jad.device_augment(*a, jparams))(img, gt, key)
    draws = jax_draws(key, B, S, partners)
    pi, pb = ad.device_augment(_t(img), _t(gt), draws, ad.AugmentParams(**probs),
                               None if pimg is None else _t(pimg),
                               None if pgt is None else _t(pgt))
    want_g = G * (4 if probs['mosaic_p'] else 1) + (G if probs['mixup_p'] else 0)
    assert pi.dtype == torch.uint8 and pb.shape == (B, want_g, 6) == np.shape(jb)
    np.testing.assert_array_equal(pb.numpy(), np.asarray(jb))
    _assert_warp_close(pi.numpy(), np.asarray(ji), case)


def test_device_augment_needs_no_host_value():
    """The chain on meta tensors (which have no values): nothing in it reads
    a device value on the host, so on the card it never synchronises."""
    d = ad.draw_augment(np.random.default_rng(0), B, S, partner_rows=4).to('meta')
    img = torch.zeros(B, S, S, 3, dtype=torch.uint8, device='meta')
    gt = torch.zeros(B, G, 6, device='meta')
    out, boxes = ad.device_augment(img, gt, d, ad.AugmentParams(**ALL_ON),
                                   torch.zeros(4 * B, S, S, 3, dtype=torch.uint8, device='meta'),
                                   torch.zeros(4 * B, G, 6, device='meta'))
    assert out.shape == (B, S, S, 3) and boxes.shape == (B, 5 * G, 6)


def test_draw_augment_record():
    """draw_augment: one generator state gives one record (the trainer's
    resume rests on it); fields of the documented shapes, ranges and types;
    a mismatched record raises."""
    a = ad.draw_augment(np.random.default_rng((3, 17)), B, S, partner_rows=4)
    b = ad.draw_augment(np.random.default_rng((3, 17)), B, S, partner_rows=4)
    c = ad.draw_augment(np.random.default_rng((3, 18)), B, S, partner_rows=4)
    assert all(torch.equal(getattr(a, k), getattr(b, k)) for k in vars(a))
    assert not torch.equal(a.hflip, c.hflip)
    n = 5 * B
    assert a.crop_box.shape == (4, n) and a.hflip.shape == (n,) and a.mosaic.shape == (B,)
    assert a.mosaic_perm.shape == (3, B) and all(sorted(p.tolist()) == list(range(B))
                                                 for p in a.mosaic_perm)
    assert ((a.xc >= S // 2) & (a.xc < S + S // 2)).all() and a.xc.dtype == torch.int64
    assert ((a.order >= 0) & (a.order < 6)).all()
    for name, (lo, hi) in (('brightness', ad.BRIGHTNESS), ('contrast', ad.CONTRAST),
                           ('saturation', ad.SATURATION)):
        v = getattr(a, name)
        assert v.dtype == torch.float32 and (v >= lo).all() and (v < hi).all()
    assert ((a.lam > 0) & (a.lam < 1)).all() and a.lam.dtype == torch.float32
    img, gt = torch.zeros(B, S, S, 3, dtype=torch.uint8), torch.zeros(B, G, 6)
    with pytest.raises(ValueError, match='draws for 20 rows'):
        ad.device_augment(img, gt, a, ad.AugmentParams())


@pytest.mark.parametrize('opts', [
    [],
    ['augment.mosaic_p', '0.5'],
    ['dataset.device_cache', 'on', 'augment.mosaic_p', '0.5'],
    ['dataset.device_cache', 'on', 'augment.fresh_partners', 'off'],
    ['dataset.device_cache', 'on', 'augment.mixup_p', '0'],
    ['augment.fresh_partners', 'on', 'augment.mosaic_p', '0.3'],
    ['augment.fresh_partners', 'true', 'augment.mixup_p', '0'],
])
def test_config_helpers_match_jax(opts):
    """fresh_partners_enabled, partner_rows_per_sample and the chain's
    probabilities as JAX reads them from the same overrides."""
    cfg, jcfg = load_config(opts=opts), jax_load_config(opts=opts)
    assert ad.fresh_partners_enabled(cfg) == jad.fresh_partners_enabled(jcfg)
    assert ad.partner_rows_per_sample(cfg) == jad.partner_rows_per_sample(jcfg)
    a = jcfg.augment
    assert tuple(ad.augment_params(cfg)) == (a.hflip_p, a.vflip_p, a.crop_p, a.color_p,
                                             a.mosaic_p, a.mixup_p)


def _step_batch(seed, partners):
    rng = np.random.default_rng(seed)
    b = {'image': _images(rng, 2), 'gt': _gt(rng, 2, g=16)}
    if partners:
        b['partner_image'], b['partner_gt'] = _images(rng, 2 * partners), _gt(rng, 2 * partners,
                                                                               g=16)
    return b


@pytest.mark.parametrize('partners', [0, 4])
def test_train_step_with_augment_matches_jax(partners):
    """One step of the shallow net at 64x64, B=2, f32, every stage on: JAX's
    jitted ``make_train_step(augment_fn=...)`` with the step's key, and the
    port's step with the draws JAX makes from the augment half of that key
    (``split(key)[0]``): the loss and its parts to 1e-5, the BN state to
    1e-5."""
    text = _shallow_cfg()
    jnet = JaxNetwork.from_cfg(text)
    params, state = jnet.init(jax.random.PRNGKey(1))
    net = DetectionNetwork.from_cfg(text)
    tp, ts = from_jax_params(params, state, net.graph, device='cpu')
    opts = [x for k, v in ALL_ON.items() for x in (f'augment.{k}', str(v))]
    jcfg, cfg = jax_load_config(opts=opts), load_config(opts=opts)
    jopt = jax_make_optimizer(schedule)
    jstep = jax.jit(jax_make_train_step(jnet, jopt, label_fn=_jax_label_fn,
                                        augment_fn=jad.augmenter_from_config(jcfg)))
    step = make_train_step(net, make_optimizer(schedule),
                           label_fn=label_assigner_from_config(Config(), device='cpu'),
                           augment_fn=ad.augmenter_from_config(cfg))
    b = _step_batch(0, partners)
    key = jax.random.PRNGKey(5)
    _, js, _, jm = jstep(params, state, jopt.init(params), jax.tree.map(jnp.asarray, b), key)
    batch = {k: _t(v) for k, v in b.items()}
    batch['draws'] = jax_draws(jax.random.split(key)[0], 2, S, partners)
    _, s, _, m = step(tp, ts, make_optimizer(schedule).init(tp), batch)
    for name in ('loss', 'giou_loss', 'conf_loss', 'class_loss'):
        np.testing.assert_allclose(float(m[name]), float(jm[name]), rtol=1e-5, err_msg=name)
    _, want_s = from_jax_params(params, jax.device_get(js), net.graph, device='cpu')
    for key_ in want_s:
        for st in ('mean', 'var'):
            np.testing.assert_allclose(s[key_][st].numpy(), want_s[key_][st].numpy(),
                                       rtol=1e-5, atol=1e-5)


def test_qat_step_augments_as_the_fp_step():
    """The QAT step with ``augment_fn`` is the QAT step on the batch the
    chain returns: the same metrics and new state bit for bit."""
    net = DetectionNetwork.from_cfg(_shallow_cfg(), quant=True)
    params, state = net.init(torch.Generator().manual_seed(0), device='cpu')
    from pqdet_tpu_torch.compress.qat import prepare_qat_state
    _, state = prepare_qat_state(net, params, state)
    cfg = load_config(opts=['augment.mosaic_p', '0.5', 'augment.color_p', '0.5'])
    labels = label_assigner_from_config(Config(), device='cpu')
    fn = ad.augmenter_from_config(cfg)
    b = {k: _t(v) for k, v in _step_batch(1, 0).items()}
    b['draws'] = ad.draw_augment(np.random.default_rng(0), 2, S)
    img, gt = fn(b['image'], b['gt'], b['draws'])
    outs = []
    for batch, augment_fn in ((b, fn), ({'image': img, 'gt': gt}, None)):
        opt = make_optimizer(schedule)
        step = make_qat_train_step(net, opt, label_fn=labels, augment_fn=augment_fn)
        outs.append(step(params, state, opt.init(params), batch))
    (_, s1, _, m1), (_, s2, _, m2) = outs
    assert all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(s1[k]['mean'], s2[k]['mean']) for k in s1 if 'mean' in s1[k])
