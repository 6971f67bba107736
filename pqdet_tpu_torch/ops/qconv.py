"""Int8 convolutions of the quantized serving path: the CUDA kernels'
wrappers and their plain versions (the port of ``pqdet_tpu/ops/pallas_qconv.py``).

Activations are NHWC int8 in the RECENTRED representation s = q_u8 - 128,
so the affine correction of the zero point folds into a per-channel bias:

    y_c = act(alpha_c * acc_c + (alpha_c * ((128 - x_zp) * colsum_c) + b_c))
    alpha_c = x_scale * w_scale_c,  colsum_c = sum_i w_ic

and a requantised output is clip(round(y * (1/out_scale) + out_zp - 128),
-128, 127) as int8; otherwise y stays f32 (the edges feeding yolo heads).
The scalars ride in one (1, 4) f32 tensor from ``make_scalars``.

- ``qconv1x1_s8``: pointwise conv, s8 x s8 -> s32 (``csrc/qconv.cu``,
  mma.sync int8 tensor-core tiles, split-K across a thread-block cluster
  where the tiles alone do not fill the card; ``plan_qconv1x1`` picks the
  tiles from the shapes);
- ``qdwconv3x3_s8``: depthwise 3x3, pad 1 with the recentred zero point,
  stride 1 or 2 (``csrc/qconv.cu``, CUDA cores: one CTA per output tile
  with its input window in shared memory; ``plan_qdwconv3x3`` picks the
  tiles from the shapes).

Each wrapper launches its kernel for a CUDA tensor and runs its plain
version for a CPU tensor; it raises on any other device. The plain
versions compute the integer sum in float64, which is exact, and then the
TPU kernels' own f32 epilogue, one torch op per rounded step, in the same
order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from pqdet_tpu_torch import resolve_device
from pqdet_tpu_torch.ops import refuse_autograd
from pqdet_tpu_torch.ops.fused_ir import ACT_CODES, MAX_CLUSTER, SMEM_TWO, _apply_act


def make_scalars(x_scale, x_zp, out_scale=None, out_zp=None, device='cuda'):
    """The (1, 4) f32 scalar vector (x_scale, x_zp, 1/out_scale, out_zp -
    128) on ``device``; (x_scale, x_zp, 1, -128) without an output edge.
    1/out_scale is taken in float64 on the host and then rounded to f32,
    as the JAX package's host-side ``make_scalars``."""
    requant = out_scale is not None
    vec = np.array([[
        np.float32(x_scale), np.float32(x_zp),
        np.float32(1.0 / (out_scale if requant else 1.0)),
        np.float32((out_zp if requant else 0.0) - 128.0),
    ]], np.float32)
    return torch.from_numpy(vec).to(resolve_device(device))


def _epilogue(acc, s, w_scale, b, colsum, act: str, requant: bool):
    """The TPU kernels' f32 epilogue on the f32 accumulator ``acc`` (one
    output channel per last-dim entry)."""
    alpha = s[0] * w_scale
    beta = alpha * ((128.0 - s[1]) * colsum) + b
    y = _apply_act(act, acc * alpha + beta)
    if requant:
        return torch.clamp(torch.round(y * s[2] + s[3]), -128, 127).to(torch.int8)
    return y


def qconv1x1_reference(x, w, w_scale, b, colsum, *, act: str, scalars,
                       requant: bool):
    """Plain version of ``qconv1x1_s8``: the s8 x s8 sum in float64 (exact),
    rounded to f32, then the epilogue. Same arguments; returns (N, H, W,
    Cout) int8 (``requant``) or f32."""
    n, h, wd, cin = x.shape
    cout = w.shape[1]
    acc = (x.reshape(-1, cin).double() @ w.double()).float()
    y = _epilogue(acc, scalars.reshape(-1).float(), w_scale.float(), b.float(),
                  colsum.float(), act, requant)
    return y.reshape(n, h, wd, cout)


def _check_stride(name, h, w, stride):
    if stride not in (1, 2):
        raise ValueError(f'{name}: stride must be 1 or 2, got {stride}')
    if stride == 2 and (h % 2 or w % 2):
        raise ValueError(f'{name}: the stride-2 depthwise kernel needs even H/W, '
                         f'got {(h, w)}')


def qdwconv3x3_reference(x, w, w_scale, b, *, act: str, stride: int, scalars,
                         requant: bool):
    """Plain version of ``qdwconv3x3_s8``: pad with round(x_zp) - 128, sum
    w * (x - (x_zp - 128)) in float64 (exact for an integer zero point),
    round to f32, then the epilogue with colsum 0. Same arguments; returns
    (N, H/stride, W/stride, C) int8 or f32."""
    n, h, wd, c = x.shape
    _check_stride('qdwconv3x3_reference', h, wd, stride)
    s = scalars.reshape(-1).float()
    x_off = (s[1] - 128.0).double()
    pad = (torch.round(s[1]).to(torch.int32) - 128).to(torch.int8)
    xp = pad.expand(n, h + 2, wd + 2, c).clone()
    xp[:, 1:-1, 1:-1] = x
    k = w.double().permute(2, 0, 1).reshape(c, 1, 3, 3)
    acc = F.conv2d((xp.double() - x_off).permute(0, 3, 1, 2), k, None, stride, 0, 1, c)
    acc = acc.permute(0, 2, 3, 1).float()
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return _epilogue(acc, s, w_scale.float(), b.float(), zero, act, requant)


def _check(fn, name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f'{fn}: {name} must be a contiguous {dtype} tensor of '
                         f'shape {tuple(shape)} on {device}, got {t.dtype} '
                         f'{tuple(t.shape)} on {t.device} (contiguous={t.is_contiguous()})')


def _check_common(fn, x, w_scale, b, scalars, act, cout):
    if act not in ACT_CODES:
        raise ValueError(f'{fn}: unsupported activation {act!r}')
    dev = x.device
    _check(fn, 'w_scale', w_scale, torch.float32, (cout,), dev)
    _check(fn, 'b', b, torch.float32, (cout,), dev)
    _check(fn, 'scalars', scalars, torch.float32, (1, 4), dev)


SMALL_M = 512        # below this many rows a CTA takes 64 of them, else 128
WIDE_TILES = 400     # more tiles than this at bn 32: take bn 64
SPLIT_CTAS = 256     # split K until the CTAs are about this many
MAX_M_BLOCKS = 65535  # the grid's y extent (M tiles): the card's limit


class QconvPlan(NamedTuple):
    """Launch plan of one pointwise int8 conv, plain ints for the C entry
    point: ``bm`` x ``bn`` output tiles, K steps of ``bk``; ``split``
    CTAs of a cluster share one tile's K steps, ``kpr`` steps each, and
    add their s32 partials through distributed shared memory (1: no
    split); ``stages`` cp.async buffers; ``smem`` dynamic shared-memory
    bytes. The grid is (n_blocks * split, m_blocks)."""
    bm: int
    bn: int
    bk: int
    split: int
    kpr: int
    stages: int
    smem: int
    m_blocks: int
    n_blocks: int

    @property
    def c_args(self):
        return (self.bm, self.bn, self.bk, self.split, self.kpr, self.stages, self.smem)


def qconv1x1_smem_bytes(bm, bn, bk, stages) -> int:
    """Dynamic shared memory of the kernel: the larger of the K loop's
    ring (``stages`` x (x tile [bm][bk+16] + w tile [bk][bn]) and the
    transposed w tile [bn][bk+16], bytes) and the s32 tile [bm][bn+4] with
    the staged outputs [bm][bn] (4 bytes each, for rows that are not
    16-byte aligned); then alpha and beta for bn channels. The C layout
    (csrc/qconv.cu, ``qlayout``) is the same formula, and the launch
    refuses a mismatch."""
    ring = stages * (bm * (bk + 16) + bk * bn) + bn * (bk + 16)
    return max(ring, bm * (bn + 4) * 4 + bm * bn * 4) + 8 * bn


@functools.lru_cache(maxsize=None)
def plan_qconv1x1(m: int, k: int, n: int) -> QconvPlan:
    """Tiles, split-K and stages of ``qconv1x1_s8`` for M = N*H*W rows, K
    input and N output channels (rules read off plan_sweep.py's sweep of
    every plan at every pointwise shape of the int8 graph, PERF.md):

    - bm 128 rows (64 below SMALL_M): eight warps of 32 rows each;
    - bn 32 columns, or 64 where N > 32 and 32 would make more than
      WIDE_TILES tiles (a warp's tile is at most 32 x 32, so three CTAs fit
      on an SM);
    - bk 32 for K <= 32 (the stem's 27 -> 32, Cin 16/24/32), 64 for K <= 64,
      else 128;
    - split: where the tiles are fewer than SPLIT_CTAS, up to 8 CTAs of a
      cluster each take kpr of the K steps (whole steps, none empty) and add
      their s32 partials in distributed shared memory: an integer sum, so
      exact in any order;
    - stages 3 where two CTAs still fit on an SM, else 2.
    Plans are cached: a forward asks for the same ones every time."""
    if min(m, k, n) < 1:
        raise ValueError(f'plan_qconv1x1: empty shape {(m, k, n)}')
    bm = 128 if m >= SMALL_M else 64
    m_blocks = -(-m // bm)
    if m_blocks > MAX_M_BLOCKS:
        raise ValueError(f'plan_qconv1x1: M={m} needs {m_blocks} row tiles, over the grid\'s '
                         f'{MAX_M_BLOCKS}')
    bn = 32 if bm == 128 and (n <= 32 or m_blocks * -(-n // 32) <= WIDE_TILES) else 64
    bk = 32 if k <= 32 else 64 if k <= 64 else 128
    n_blocks = -(-n // bn)
    ksteps = -(-k // bk)
    split = max(1, min(MAX_CLUSTER, ksteps, SPLIT_CTAS // (m_blocks * n_blocks)))
    kpr = -(-ksteps // split)
    split = -(-ksteps // kpr)
    stages = 3 if qconv1x1_smem_bytes(bm, bn, bk, 3) <= SMEM_TWO else 2
    return QconvPlan(bm, bn, bk, split, kpr, stages,
                     qconv1x1_smem_bytes(bm, bn, bk, stages), m_blocks, n_blocks)


DW_PX = 4            # output columns a depthwise thread takes
DW_THREADS = 256     # threads of a depthwise CTA


class DwPlan(NamedTuple):
    """Launch plan of one depthwise int8 conv, plain ints for the C entry
    point: output tiles of ``th`` rows x ``tw`` columns x ``cs`` channels
    (all powers of two); the input window comes in by copies of ``cw``
    bytes (16, 8, 4 or 1: the widest that divides C); ``smem`` dynamic
    shared-memory bytes; ``grid`` CTAs, one a tile (N * tiles_y * tiles_x *
    slices, the slices of a tile neighbours)."""
    th: int
    tw: int
    cs: int
    cw: int
    smem: int
    grid: int
    tiles_x: int
    tiles_y: int
    slices: int

    @property
    def c_args(self):
        return (self.th, self.tw, self.cs, self.cw, self.smem, self.grid)


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, (v - 1).bit_length())


def qdwconv3x3_smem_bytes(th, tw, cs, stride) -> int:
    """Dynamic shared memory of the depthwise kernel: the s8 input window,
    (th-1)*stride+3 rows of (tw-1)*stride+3 pixels x cs channels, each row
    padded to 128 bytes and then skewed by max(16, (cs or cs/2) % 128)
    bytes so the rows a warp reads sit on other banks; the s8 weights
    [9][cs] (rounded up to 16 bytes); f32 w_scale and bias [cs] each; the
    staged s8 codes, th rows of tw*cs bytes skewed by max(16, cs % 128).
    The C layout (csrc/qconv.cu, ``dwlayout``) is the same formula, and
    the launch refuses a mismatch."""
    wr, wc = (th - 1) * stride + 3, (tw - 1) * stride + 3
    skew = (cs if stride == 1 else cs // 2) % 128
    rp = -(-wc * cs // 128) * 128 + max(16, skew)
    buf = wr * rp + -(-9 * cs // 16) * 16 + 8 * cs
    return buf + th * (tw * cs + max(16, cs % 128))


@functools.lru_cache(maxsize=None)
def plan_qdwconv3x3(n: int, h: int, w: int, c: int, stride: int) -> DwPlan:
    """Tiles of ``qdwconv3x3_s8`` for an (N, H, W, C) input at ``stride``
    (rules read off plan_sweep.py's sweep of every plan at every depthwise
    shape of the int8 graph, PERF.md):

    - cs: 64 channels where 64 divides C, else 32 (C 20, 27, 75 and 144
      end in a partly masked slice);
    - cw: the widest copy of 16, 8, 4 or 1 bytes that divides C;
    - tw: 16 columns where Wo <= 32, else 32;
    - th: where Ho >= 128, 16 rows at stride 1 and 8 at stride 2 (a window
      of 18 or 17 rows), else 4; at most Ho rounded up to a power of two;
    - grid: one CTA a tile.
    A thread takes units of one row x DW_PX columns x 4 channels (1 where
    C % 4 != 0).
    Plans are cached: a forward asks for the same ones every time."""
    _check_stride('plan_qdwconv3x3', h, w, stride)
    if min(n, h, w, c) < 1:
        raise ValueError(f'plan_qdwconv3x3: empty shape {(n, h, w, c)}')
    ho, wo = h // stride, w // stride
    cs = 64 if c % 64 == 0 else 32
    cw = next(k for k in (16, 8, 4, 1) if c % k == 0)
    tw = 16 if wo <= 32 else 32
    th = min(_pow2_at_least(ho), 16 // stride if ho >= 128 else 4)
    slices, tiles_x, tiles_y = -(-c // cs), -(-wo // tw), -(-ho // th)
    return DwPlan(th, tw, cs, cw, qdwconv3x3_smem_bytes(th, tw, cs, stride),
                  n * tiles_y * tiles_x * slices, tiles_x, tiles_y, slices)


@functools.lru_cache(maxsize=None)
def _library():
    from pqdet_tpu_torch.ops._build import load_library
    lib = load_library('qconv')
    lib.qconv1x1_launch.restype = ctypes.c_int
    lib.qconv1x1_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 \
        + [ctypes.c_void_p]
    lib.qdw3x3_launch.restype = ctypes.c_int
    lib.qdw3x3_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 13 \
        + [ctypes.c_void_p]
    return lib


def qconv1x1_s8(x, w, w_scale, b, colsum, *, act: str, scalars, requant: bool):
    """Fused quantized 1x1 conv (stride 1, groups 1), NHWC in and out.

    x: (N, H, W, Cin) int8 recentred; w: (Cin, Cout) int8; w_scale, b:
    (Cout,) f32; colsum: (Cout,) int32, the per-channel sum of w; scalars:
    (1, 4) f32 from ``make_scalars``. Returns (N, H, W, Cout) int8 when
    ``requant``, else f32. Launches the CUDA kernel for a CUDA tensor
    (RuntimeError when grad mode is on and an input requires grad: the
    kernel has no backward), runs ``qconv1x1_reference`` for a CPU tensor."""
    if x.device.type == 'cpu':
        return qconv1x1_reference(x, w, w_scale, b, colsum, act=act,
                                  scalars=scalars, requant=requant)
    refuse_autograd('qconv1x1_s8', x, w, w_scale, b, colsum, scalars)
    if x.device.type != 'cuda':
        raise ValueError(f'qconv1x1_s8: no kernel for device {x.device}')
    n, h, wd, cin = x.shape
    cout = w.shape[1]
    dev = x.device
    _check('qconv1x1_s8', 'x', x, torch.int8, (n, h, wd, cin), dev)
    _check('qconv1x1_s8', 'w', w, torch.int8, (cin, cout), dev)
    _check('qconv1x1_s8', 'colsum', colsum, torch.int32, (cout,), dev)
    _check_common('qconv1x1_s8', x, w_scale, b, scalars, act, cout)
    out = torch.empty((n, h, wd, cout), dtype=torch.int8 if requant else torch.float32,
                      device=dev)
    if out.numel() == 0:
        return out
    rc = _library().qconv1x1_launch(
        x.data_ptr(), w.data_ptr(), w_scale.data_ptr(), b.data_ptr(),
        colsum.data_ptr(), scalars.data_ptr(), out.data_ptr(), n * h * wd, cin,
        cout, ACT_CODES[act], int(requant), *plan_qconv1x1(n * h * wd, cin, cout).c_args,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'qconv1x1_s8: kernel launch failed with CUDA error {rc}')
    qconv1x1_s8.launches += 1
    return out


qconv1x1_s8.launches = 0


def qdwconv3x3_s8(x, w, w_scale, b, *, act: str, stride: int, scalars,
                  requant: bool):
    """Fused quantized depthwise 3x3 conv (padding 1), NHWC s8 -> NHWC s8/f32.

    x: (N, H, W, C) int8 recentred; w: (3, 3, C) int8; w_scale, b: (C,)
    f32; scalars: (1, 4) f32 from ``make_scalars``. Output (N, H, W, C) at
    stride 1 and (N, H/2, W/2, C) at stride 2, where H and W must be even
    (ValueError otherwise, as the TPU kernel). Launches the CUDA kernel for
    a CUDA tensor (RuntimeError when grad mode is on and an input requires
    grad), runs ``qdwconv3x3_reference`` for a CPU tensor."""
    n, h, wd, c = x.shape
    _check_stride('qdwconv3x3_s8', h, wd, stride)
    if x.device.type == 'cpu':
        return qdwconv3x3_reference(x, w, w_scale, b, act=act, stride=stride,
                                    scalars=scalars, requant=requant)
    refuse_autograd('qdwconv3x3_s8', x, w, w_scale, b, scalars)
    if x.device.type != 'cuda':
        raise ValueError(f'qdwconv3x3_s8: no kernel for device {x.device}')
    dev = x.device
    _check('qdwconv3x3_s8', 'x', x, torch.int8, (n, h, wd, c), dev)
    _check('qdwconv3x3_s8', 'w', w, torch.int8, (3, 3, c), dev)
    _check_common('qdwconv3x3_s8', x, w_scale, b, scalars, act, c)
    out = torch.empty((n, h // stride, wd // stride, c),
                      dtype=torch.int8 if requant else torch.float32, device=dev)
    if out.numel() == 0:
        return out
    # the copies want 16-byte boundaries: a view off one is copied first
    x, w, w_scale, b = (t.clone() if t.data_ptr() % 16 else t for t in (x, w, w_scale, b))
    rc = _library().qdw3x3_launch(
        x.data_ptr(), w.data_ptr(), w_scale.data_ptr(), b.data_ptr(),
        scalars.data_ptr(), out.data_ptr(), n, h, wd, c, stride, ACT_CODES[act],
        int(requant), *plan_qdwconv3x3(n, h, wd, c, stride).c_args,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'qdwconv3x3_s8: kernel launch failed with CUDA error {rc}')
    qdwconv3x3_s8.launches += 1
    return out


qdwconv3x3_s8.launches = 0
