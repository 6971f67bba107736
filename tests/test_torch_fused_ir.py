"""pqdet_tpu_torch fused inverted-residual block against the JAX package:
the port's plain version (the CPU path of the CUDA kernel's wrapper)
against ``fused_ir_reference`` and the Pallas kernel in interpret mode, on
the same numpy weights; and the fusion table of mobilenetv2-fpn.

Tolerance: 0.02 * max(1, |ref|max) with a median below tol/4, as in
tests/test_pallas_fused.py: bf16 paths on both sides, rounding at the same
three stage boundaries, sums taken in another order."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
from pqdet_tpu.ops.pallas_fused import find_fused_triples as jax_find
from pqdet_tpu.ops.pallas_fused import fused_ir_conv as jax_fused_ir_conv
from pqdet_tpu.ops.pallas_fused import fused_ir_reference as jax_reference
from pqdet_tpu.ops.pallas_fused import pad_fused_weights as jax_pad
from pqdet_tpu.zoo import get_cfg as jax_get_cfg
from pqdet_tpu_torch.bridge import hwio_to_oihw
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.ops.fused_ir import (find_fused_triples, fused_ir_conv,
                                          fused_ir_reference, pad_fused_weights)
from pqdet_tpu_torch.zoo import get_cfg


def _block(rng, cin, e, cout, bias_shift=0.0):
    we = rng.randn(1, 1, cin, e).astype(np.float32) * 0.2
    be = rng.randn(e).astype(np.float32) * 0.1 + bias_shift
    wdw = rng.randn(3, 3, 1, e).astype(np.float32) * 0.2
    bdw = rng.randn(e).astype(np.float32) * 0.1
    wp = rng.randn(1, 1, e, cout).astype(np.float32) * 0.2
    bp = rng.randn(cout).astype(np.float32) * 0.1
    return we, be, wdw, bdw, wp, bp


def _port_weights(we, be, wdw, bdw, wp, bp):
    """JAX-layout (HWIO) block weights -> the port's kernel layout."""
    t = torch.from_numpy
    return pad_fused_weights(None if we is None else t(hwio_to_oihw(we)),
                             None if be is None else t(be), t(hwio_to_oihw(wdw)),
                             t(bdw), t(hwio_to_oihw(wp)), t(bp))[:6]


def _close(o, r):
    tol = 0.02 * max(1.0, np.abs(r).max())
    np.testing.assert_allclose(o, r, atol=tol)
    assert np.median(np.abs(o - r)) < tol / 4


@pytest.mark.parametrize('cin,e,cout,h,w,bias_shift', [
    (32, 192, 32, 16, 16, 0.0),    # the shapes of tests/test_pallas_fused.py
    (24, 144, 24, 8, 24, 0.0),
    (16, 128, 48, 12, 8, 0.0),
    (16, 128, 16, 8, 8, 3.0),      # border/bias case: relu6(expand(0)) ~ 3
])
def test_fused_ir_matches_jax(cin, e, cout, h, w, bias_shift):
    rng = np.random.RandomState(0 if not bias_shift else 2)
    x = rng.randn(2, h, w, cin).astype(np.float32)
    blk = _block(rng, cin, e, cout, bias_shift)
    ref = np.asarray(jax_reference(jnp.asarray(x), *blk), np.float32)
    wep, bep, wdw9, bdwp, wpp, bpp, _ = jax_pad(*blk)
    pallas = np.asarray(jax_fused_ir_conv(
        jnp.asarray(x, jnp.bfloat16), *map(jnp.asarray, (wep, bep, wdw9, bdwp, wpp, bpp)),
        interpret=True)[..., :cout], np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    plain = fused_ir_reference(xt, *_port_weights(*blk))
    wrapped = fused_ir_conv(xt, *_port_weights(*blk))
    assert plain.dtype == wrapped.dtype == torch.bfloat16
    assert tuple(plain.shape) == ref.shape
    _close(plain.float().numpy(), ref)
    _close(plain.float().numpy(), pallas)
    np.testing.assert_array_equal(wrapped.float().numpy(), plain.float().numpy())


def test_fused_pair_no_expand():
    """Bare dw3x3 + pw1x1 pair (E == Cin == one 128-channel tile)."""
    rng = np.random.RandomState(1)
    e, cout, h, w = 128, 64, 8, 8
    x = rng.randn(1, h, w, e).astype(np.float32)
    _, _, wdw, bdw, wp, bp = _block(rng, e, e, cout)
    ref = np.asarray(jax_reference(jnp.asarray(x), None, None, wdw, bdw, wp, bp),
                     np.float32)
    out = fused_ir_conv(torch.from_numpy(x).to(torch.bfloat16),
                        *_port_weights(None, None, wdw, bdw, wp, bp))
    _close(out.float().numpy(), ref)


@pytest.mark.parametrize('expand', [True, False])
def test_pad_fused_weights_matches_jax(expand):
    """The port's kernel layout is JAX's without its 128-lane pads (E 144
    -> 256, P 40 -> 128 there): the CUDA kernel masks ragged tiles."""
    rng = np.random.RandomState(3)
    blk = _block(rng, 24, 144, 40)
    if not expand:
        blk = (None, None) + blk[2:]
    jw = jax_pad(*blk)
    pw = _port_weights(*blk)
    assert jw[6] == 40 and tuple(pw[4].shape) == (144, 40)
    for got, want in zip(pw, jw[:6]):
        if want is None:
            assert got is None
            continue
        want = np.asarray(want)
        cut = want[tuple(slice(0, s) for s in got.shape)]
        np.testing.assert_array_equal(got.numpy(), cut)
        assert not (want != 0).sum() - (cut != 0).sum()    # the pads are all 0


def test_fused_ir_kernel_counts_no_cpu_launch():
    rng = np.random.RandomState(4)
    blk = _block(rng, 8, 16, 8)
    before = fused_ir_conv.launches
    fused_ir_conv(torch.zeros(1, 4, 4, 8, dtype=torch.bfloat16), *_port_weights(*blk))
    assert fused_ir_conv.launches == before


def test_find_fused_triples_same_21_as_jax():
    port = find_fused_triples(DetectionNetwork.from_cfg(get_cfg('mobilenetv2-fpn')).graph)
    ref = jax_find(JaxNetwork.from_cfg(jax_get_cfg('mobilenetv2-fpn')).graph)
    assert port == ref
    assert len(port) == 21
    assert [t for t in port if t[0] is None] == [(None, 69, 70), (None, 84, 85)]

