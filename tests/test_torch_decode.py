"""pqdet_tpu_torch YOLO head decode against the JAX package's decode and its
Pallas kernel (interpret mode), on the same numpy heads, one head at a time
and as ``decode_heads`` of three heads into one preds tensor. On CPU
tensors the port's kernel wrapper runs the plain decode, so both are
checked.

Tolerance: rtol = atol = 1e-5, f32 exp and sigmoid on both sides, whose
exps may differ by an ulp. Scores are held to it as they are. A box
coordinate (centre -/+ exp(d)) * stride cancels where exp(d) ~ centre, so
its 1e-5 is taken relative to the operands, stride * (centre + exp(d)):
an ulp of exp(d) there is no longer small next to the result."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from pqdet_tpu.model.decode import decode as jax_decode
from pqdet_tpu.ops.pallas_decode import decode_pallas
from pqdet_tpu_torch.model.decode import decode
from pqdet_tpu_torch.ops.decode_kernel import decode_heads, decode_heads_reference, head_views

TOL = dict(rtol=1e-5, atol=1e-5)


def assert_decode_close(out, ref, raw, nc, stride, exp_cap=0.0):
    """``out`` and ``ref`` (B, H, W, A, 5+C) decodes of ``raw``."""
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_allclose(out[..., 4:], ref[..., 4:], **TOL)
    b, h, w, a, ch = ref.shape
    d = np.asarray(raw, np.float64).reshape(b, h, w, a, ch)[..., :4]
    if exp_cap:
        d = np.minimum(d, exp_cap)
    cy, cx = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing='ij')
    centre = np.stack([cx, cy, cx, cy], -1)[:, :, None, :]
    tol = TOL['atol'] + TOL['rtol'] * stride * (centre + np.exp(d))
    err = np.abs(out[..., :4] - ref[..., :4])
    assert (err <= tol).all(), f'box error {err.max()} above its tolerance'


@pytest.mark.parametrize('b,h,w,a,nc,stride,exp_cap', [
    (2, 16, 16, 3, 20, 32, 0.0),   # the cases of tests/test_pallas.py
    (1, 8, 12, 3, 4, 16, 0.0),
    (1, 64, 64, 3, 10, 8, 0.0),
    (2, 7, 9, 3, 20, 8, 0.0),      # odd H: the Pallas kernel's fallback case
    (1, 8, 8, 3, 20, 16, 1.5),     # exp_cap clamps before the exp
])
def test_decode_matches_jax(b, h, w, a, nc, stride, exp_cap):
    rng = np.random.RandomState(0)
    raw = (rng.randn(b, h, w, a * (5 + nc)) * 2).astype(np.float32)
    ref = np.asarray(jax_decode(jnp.asarray(raw), nc, stride, exp_cap=exp_cap))
    if not exp_cap:   # the Pallas kernel takes bare-exp graphs only
        pallas = np.asarray(decode_pallas(jnp.asarray(raw), nc, stride, interpret=True))
        assert_decode_close(pallas, ref, raw, nc, stride)
    plain = decode(torch.from_numpy(raw), nc, stride, exp_cap=exp_cap)
    wrapped = decode_heads([torch.from_numpy(raw)], nc, [stride], [exp_cap])
    wrapped = wrapped.view(b, h, w, a, 5 + nc)
    assert plain.shape == ref.shape == (b, h, w, a, 5 + nc)
    assert plain.dtype == wrapped.dtype == torch.float32
    assert_decode_close(plain.numpy(), ref, raw, nc, stride, exp_cap)
    np.testing.assert_array_equal(wrapped.numpy(), plain.numpy())


def test_decode_bf16_head():
    """A bf16 head (the bf16 walk's) decodes to f32 like JAX's."""
    raw = np.random.RandomState(1).randn(2, 8, 8, 75).astype(np.float32)
    bf = jnp.asarray(raw, jnp.bfloat16)
    ref = np.asarray(jax_decode(bf, 20, 16))
    out = decode_heads([torch.from_numpy(raw).to(torch.bfloat16)], 20, [16], [0.0])
    assert out.shape == (2, 8 * 8 * 3, 25)
    assert_decode_close(out.view(2, 8, 8, 3, 25).numpy(), ref, np.asarray(bf, np.float32),
                        20, 16)


def test_decode_kernel_counts_no_cpu_launch():
    """The launch count moves only where the kernel launches: never on the
    CPU path."""
    before = decode_heads.launches
    decode_heads([torch.zeros(1, 2, 2, 75), torch.zeros(1, 1, 1, 75)], 20, [8, 16], [0.0, 0.0])
    assert decode_heads.launches == before


HEADS = [(16, 16, 8), (8, 8, 16), (4, 4, 32)]     # (H, W, stride): three scales


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('exp_caps', [(0.0, 0.0, 0.0), (1.5, 0.0, 2.0)])
def test_decode_heads_matches_jax(dtype, exp_caps):
    """Three heads of different strides into one (B, sum HWA, 5+C) tensor,
    against JAX's decode of each head (and its Pallas kernel in interpret
    mode where no head is capped), flattened and concatenated."""
    b, a, nc = 2, 3, 20
    rng = np.random.RandomState(7)
    raws = [(rng.randn(b, h, w, a * (5 + nc)) * 2).astype(np.float32) for h, w, _ in HEADS]
    jdt = jnp.bfloat16 if dtype == 'bfloat16' else jnp.float32
    jraws = [jnp.asarray(r, jdt) for r in raws]
    refs = [np.asarray(jax_decode(r, nc, s, exp_cap=cap))
            for r, (_, _, s), cap in zip(jraws, HEADS, exp_caps)]
    if not any(exp_caps):
        for r, ref, (_, _, s) in zip(jraws, refs, HEADS):
            pallas = np.asarray(decode_pallas(r, nc, s, interpret=True))
            assert_decode_close(pallas, ref, np.asarray(r, np.float32), nc, s)
    traws = [torch.from_numpy(r).to(getattr(torch, dtype)) for r in raws]
    out = decode_heads(traws, nc, [s for *_, s in HEADS], list(exp_caps))
    rows = sum(h * w * a for h, w, _ in HEADS)
    assert out.shape == (b, rows, 5 + nc) and out.dtype == torch.float32
    views = head_views(out, [r.shape for r in traws])
    for view, ref, r, (_, _, s), cap in zip(views, refs, jraws, HEADS, exp_caps):
        assert view.shape == ref.shape and view.data_ptr() >= out.data_ptr()
        assert_decode_close(view.numpy(), ref, np.asarray(r, np.float32), nc, s, cap)
    flat = np.concatenate([ref.reshape(b, -1, 5 + nc) for ref in refs], 1)
    np.testing.assert_array_equal(out.numpy(), torch.cat(
        [v.reshape(b, -1, 5 + nc) for v in views], 1).numpy())
    assert np.abs(out.numpy() - flat)[..., 4:].max() <= 1e-5
    torch.testing.assert_close(out, decode_heads_reference(
        traws, nc, [s for *_, s in HEADS], list(exp_caps)), rtol=0, atol=0)


def test_decode_heads_refuses():
    """Mismatched argument lists, and devices with no kernel."""
    raw = torch.zeros(1, 2, 2, 75)
    with pytest.raises(ValueError, match='heads'):
        decode_heads([raw, raw], 20, [8], [0.0, 0.0])
    with pytest.raises(ValueError, match='no kernel for device'):
        decode_heads([raw.to('meta')], 20, [8], [0.0])
