"""YOLO head decode as a Triton kernel, with its wrapper and launch count.

Replaces the TPU kernel ``pqdet_tpu/ops/pallas_decode.py::decode_pallas``
(``_decode_kernel``). Its plain version is ``decode_heads_reference``: the
plain ``model/decode.py::decode`` of each head, concatenated.

What bounds it on this card: bytes. It is one elementwise pass (an exp or
a sigmoid per element, no reuse, no product) that reads each raw head once
(bf16 or f32) and writes the f32 decode once; at 512x512 and batch 4 the
three heads of mobilenetv2-fpn are about 3.2 MB in and 6.5 MB out, under 3
microseconds at 3.35 TB/s, so a launch costs about as much as the work.
The design therefore launches once for all heads of a forward and writes
straight into the (B, sum HWA, 5+C) preds, so no concatenation follows:

- one grid spans the blocks of every head (per image: axis 1 is the
  image); each program finds its head by comparing its block index with
  the heads' cumulative block counts, and decodes a contiguous block of
  that head with masked loads and stores, so a ragged H (the TPU kernel's
  fallback case, ``pallas_decode.py:66-67``) needs no branch;
- the heads reach the kernel as up to ``MAX_HEADS`` pointer and scalar
  arguments with a ``constexpr`` head count: a descriptor tensor would
  need a host-to-device copy per call (the pointers change every
  forward), arguments cost nothing;
- a head's row r of the preds is its pixel * A + anchor, so the input's
  flat index within an image is the output's, offset by the head's first
  row; ``exp_cap`` (0 = none) is applied before the exp, per head.

``decode_heads`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; it raises on any other device. ``triton`` is
imported inside the launching function only: the CPU tests import this
module on a machine without it.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

from pqdet_tpu_torch.model.decode import decode
from pqdet_tpu_torch.ops import refuse_autograd

BLOCK = 1024
MAX_HEADS = 4


@functools.lru_cache(maxsize=None)
def _kernel():
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def decode_block(x_ptr, out_ptr, blk, b, n_elem, out_img, row0, width, ch_total,
                     ch, stride, exp_cap, BLOCK: tl.constexpr):
        idx = blk * BLOCK + tl.arange(0, BLOCK)
        mask = idx < n_elem
        v = tl.load(x_ptr + b * n_elem + idx, mask=mask, other=0.0).to(tl.float32)
        c = idx % ch_total              # channel within the pixel: a*(5+C)+k
        pix = idx // ch_total
        k = c % ch
        cx = (pix % width).to(tl.float32) + 0.5
        cy = (pix // width).to(tl.float32) + 0.5
        d = tl.where(exp_cap > 0, tl.minimum(v, exp_cap), v)
        # libdevice's expf, as PyTorch's own CUDA exp (tl.exp is ex2.approx)
        e = libdevice.exp(d)
        centre = tl.where((k == 0) | (k == 2), cx, cy)
        box = tl.where(k < 2, centre - e, centre + e) * stride
        score = 1.0 / (1.0 + libdevice.exp(-v))
        tl.store(out_ptr + b * out_img + row0 * ch + idx, tl.where(k < 4, box, score),
                 mask=mask)

    @triton.jit
    def decode_kernel(out_ptr, out_img, ch, ch_total,
                      x0, n0, r0, w0, s0, e0, c0,
                      x1, n1, r1, w1, s1, e1, c1,
                      x2, n2, r2, w2, s2, e2, c2,
                      x3, n3, r3, w3, s3, e3,
                      NH: tl.constexpr, BLOCK: tl.constexpr):
        # c<i>: blocks of heads 0..i, cumulative; head i takes [c<i-1>, c<i>).
        # The head count prunes the branches of absent heads at compile time.
        pid = tl.program_id(0)
        b = tl.program_id(1)
        if pid < c0:
            decode_block(x0, out_ptr, pid, b, n0, out_img, r0, w0, ch_total, ch, s0, e0,
                         BLOCK)
        else:
            if NH > 1:
                if pid < c1:
                    decode_block(x1, out_ptr, pid - c0, b, n1, out_img, r1, w1, ch_total,
                                 ch, s1, e1, BLOCK)
                else:
                    if NH > 2:
                        if pid < c2:
                            decode_block(x2, out_ptr, pid - c1, b, n2, out_img, r2, w2,
                                         ch_total, ch, s2, e2, BLOCK)
                        else:
                            if NH > 3:
                                decode_block(x3, out_ptr, pid - c2, b, n3, out_img, r3,
                                             w3, ch_total, ch, s3, e3, BLOCK)

    return triton, decode_kernel


def decode_heads_reference(raws: Sequence[torch.Tensor], num_classes: int,
                           strides: Sequence[int],
                           exp_caps: Sequence[float]) -> torch.Tensor:
    """Plain version of ``decode_heads``: each head's plain decode, flattened
    to (B, H*W*A, 5+C) and concatenated along the rows."""
    flat = [decode(r, num_classes, s, exp_cap=cap).flatten(1, 3)
            for r, s, cap in zip(raws, strides, exp_caps)]
    return flat[0] if len(flat) == 1 else torch.cat(flat, dim=1)


def head_views(preds: torch.Tensor, shapes: Sequence[torch.Size]):
    """Per-head (B, H, W, A, 5+C) views of the (B, sum HWA, 5+C) preds of
    raw heads of ``shapes`` (B, H, W, A*(5+C)), in order: the layout of
    ``Network.forward``'s decoded heads, sharing the preds' storage."""
    b, _, ch = preds.shape
    views, row = [], 0
    for _, h, w, ct in shapes:
        a = ct // ch
        views.append(preds[:, row:row + h * w * a].view(b, h, w, a, ch))
        row += h * w * a
    return views


def decode_heads(raws: Sequence[torch.Tensor], num_classes: int,
                 strides: Sequence[int], exp_caps: Sequence[float]) -> torch.Tensor:
    """Raw heads, each (B, H_i, W_i, A_i*(5+C)) f32, bf16 or f16, -> the
    (B, sum H_i W_i A_i, 5+C) f32 preds, head after head. One kernel launch
    for CUDA tensors (at most ``MAX_HEADS`` heads), which raises when grad
    mode is on and a head requires grad (the kernel has no backward); the
    plain version, differentiable, for CPU tensors."""
    if not 1 <= len(raws) == len(strides) == len(exp_caps):
        raise ValueError(f'decode_heads: {len(raws)} heads, {len(strides)} strides, '
                         f'{len(exp_caps)} exp caps')
    dev = raws[0].device
    if dev.type == 'cpu':
        return decode_heads_reference(raws, num_classes, strides, exp_caps)
    refuse_autograd('decode_heads', *raws)
    if dev.type != 'cuda':
        raise ValueError(f'decode_heads: no kernel for device {dev}')
    if len(raws) > MAX_HEADS:
        raise ValueError(f'decode_heads: the kernel takes at most {MAX_HEADS} heads, '
                         f'got {len(raws)}')
    ch = 5 + num_classes
    b, _, _, ch_total = raws[0].shape
    for r in raws:
        if r.device != dev or r.dim() != 4 or r.shape[0] != b or r.shape[3] != ch_total \
                or ch_total % ch or r.dtype != raws[0].dtype or not r.is_contiguous() \
                or r.dtype not in (torch.float32, torch.bfloat16, torch.float16):
            raise ValueError(
                f'decode_heads: needs contiguous float NHWC heads of one dtype, batch, '
                f'device and channel count, a multiple of 5+C={ch}; got {r.dtype} '
                f'{tuple(r.shape)} on {r.device} (contiguous={r.is_contiguous()})')
    rows = [r.shape[1] * r.shape[2] * (ch_total // ch) for r in raws]
    out = torch.empty((b, sum(rows), ch), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    triton, kernel = _kernel()
    heads, row0, blocks = [], 0, 0
    for r, s, cap, n_rows in zip(raws, strides, exp_caps, rows):
        n_elem = r[0].numel()
        blocks += triton.cdiv(n_elem, BLOCK)
        heads.append([r, n_elem, row0, r.shape[2], int(s), float(cap), blocks])
        row0 += n_rows
    heads += [heads[-1]] * (MAX_HEADS - len(heads))     # absent heads: pruned by NH
    args = [a for h in heads for a in h][:-1]          # the last takes no block count
    with torch.cuda.device(dev):
        kernel[(blocks, b)](out, out.shape[1] * ch, ch, ch_total, *args,
                            NH=len(raws), BLOCK=BLOCK, num_warps=4)
    decode_heads.launches += 1
    return out


decode_heads.launches = 0
