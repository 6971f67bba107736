"""YOLO head decode as a Triton kernel, with its wrapper and launch count.

Replaces the TPU kernel ``pqdet_tpu/ops/pallas_decode.py::decode_pallas``
(``_decode_kernel``). Its plain version is ``model/decode.py::decode``.

What bounds it on this card: bytes. It is one elementwise pass (an exp or
a sigmoid per element, no reuse, no product) that reads the raw head once
(bf16 or f32) and writes the f32 decode once; at 512x512 and batch 4 the
three heads are about 1.3-2.6 MB in and 4.8 MB out, a few microseconds at
3.35 TB/s, so in practice launch latency dominates. The design does
nothing more than the pass needs: one program decodes a contiguous block
of one image's head with masked loads and stores, so a ragged H (the TPU
kernel's fallback case, ``pallas_decode.py:66-67``) needs no branch, and
``exp_cap`` (0 = none) is an argument applied before the exp, so no CUDA
path ever runs the plain decode.

``decode_head`` launches the kernel for a CUDA tensor and runs the plain
decode for a CPU tensor; it raises on any other device. ``triton`` is
imported inside the launching function only: the CPU tests import this
module on a machine without it.
"""

from __future__ import annotations

import functools

import torch

from pqdet_tpu_torch.model.decode import decode

BLOCK = 1024


@functools.lru_cache(maxsize=None)
def _kernel():
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def decode_kernel(x_ptr, out_ptr, n_elem, width, ch_total, ch,
                      stride, exp_cap, BLOCK: tl.constexpr):
        b = tl.program_id(1)
        idx = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
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
        tl.store(out_ptr + b * n_elem + idx, tl.where(k < 4, box, score), mask=mask)

    return triton, decode_kernel


def decode_head(conv: torch.Tensor, num_classes: int, stride: int,
                exp_cap: float = 0.0) -> torch.Tensor:
    """(B, H, W, A*(5+C)) raw head, f32 or bf16 -> (B, H, W, A, 5+C) f32."""
    if conv.device.type == 'cpu':
        return decode(conv, num_classes, stride, exp_cap=exp_cap)
    if conv.device.type != 'cuda':
        raise ValueError(f'decode_head: no kernel for device {conv.device}')
    b, h, w, ch_total = conv.shape
    ch = 5 + num_classes
    if ch_total % ch:
        raise ValueError(f'decode_head: {ch_total} channels is not a multiple of 5+C={ch}')
    if conv.dtype not in (torch.float32, torch.bfloat16, torch.float16) \
            or not conv.is_contiguous():
        raise ValueError(f'decode_head: needs a contiguous float NHWC head, got '
                         f'{conv.dtype} contiguous={conv.is_contiguous()}')
    out = torch.empty((b, h, w, ch_total // ch, ch), dtype=torch.float32,
                      device=conv.device)
    n_elem = h * w * ch_total
    if out.numel() == 0:
        return out
    triton, kernel = _kernel()
    with torch.cuda.device(conv.device):
        kernel[(triton.cdiv(n_elem, BLOCK), b)](
            conv, out, n_elem, w, ch_total, ch, stride, float(exp_cap),
            BLOCK=BLOCK, num_warps=4)
    decode_head.launches += 1
    return out


decode_head.launches = 0
