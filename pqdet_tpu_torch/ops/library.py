"""The port's kernels as registered PyTorch operators, so that a
``torch.export`` program can carry them (the counterpart of the Pallas
calls that ``jax.export`` embeds as custom calls).

``decode_heads``, ``qconv1x1_s8``, ``qdwconv3x3_s8``, ``qconv3x3_s8``,
``qgconv3x3_s8`` and ``int8_sandwich`` are registered in the ``pqdet`` namespace with
``torch.library.custom_op``. Each op is opaque to the tracer: its
implementation is the kernel's wrapper, looked up in its module at call
time, which launches the kernel for a CUDA tensor (counting the launch) or
raises, and runs the plain version for a CPU tensor. Nothing falls back:
an artifact whose kernels cannot build raises where the wrapper raises.
Each op has a fake (shape) function that mirrors the wrapper's output:
int8 when ``requant``, f32 otherwise; H/2 x W/2 at stride 2; the dense
3x3's Cout from its (Cout, 9 * Cin) weights, the grouped 3x3's its
input's Cin; the (B, sum HWA, 5+C) f32
preds of the decode; the sandwich's int8 (N, H, W, C), C summed over a
route's sources. The decode is a
``custom_op`` too, not a ``triton_op``, so the Triton kernel stays out of
the traced graph.

The functions below have the wrappers' signatures and call through
``torch.ops``. ``compress.quantized.Int8Inference.apply`` takes one of
three ``Kernels`` tables: ``OPS``, these functions, in an exported
program; ``WRAPPERS`` on the eager serving path, with no operator
dispatch; ``PLAIN``, their plain versions. A table sets how each kernel
runs, never which route a node takes.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence

import torch

from pqdet_tpu_torch.ops import decode_kernel, qconv

NAMESPACE = 'pqdet'
OP_NAMES = ('decode_heads', 'qconv1x1_s8', 'qdwconv3x3_s8', 'int8_sandwich', 'qconv3x3_s8',
            'qgconv3x3_s8')


@torch.library.custom_op(f'{NAMESPACE}::qconv1x1_s8', mutates_args=())
def _qconv1x1_op(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                 b: torch.Tensor, colsum: torch.Tensor, scalars: torch.Tensor,
                 act: str, requant: bool) -> torch.Tensor:
    return qconv.qconv1x1_s8(x, w, w_scale, b, colsum, act=act, scalars=scalars,
                             requant=requant)


@_qconv1x1_op.register_fake
def _(x, w, w_scale, b, colsum, scalars, act, requant):
    n, h, wd, _ = x.shape
    return x.new_empty((n, h, wd, w.shape[1]),
                       dtype=torch.int8 if requant else torch.float32)


@torch.library.custom_op(f'{NAMESPACE}::qdwconv3x3_s8', mutates_args=())
def _qdwconv3x3_op(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                   b: torch.Tensor, scalars: torch.Tensor, act: str, stride: int,
                   requant: bool) -> torch.Tensor:
    return qconv.qdwconv3x3_s8(x, w, w_scale, b, act=act, stride=stride, scalars=scalars,
                               requant=requant)


@_qdwconv3x3_op.register_fake
def _(x, w, w_scale, b, scalars, act, stride, requant):
    n, h, wd, c = x.shape
    return x.new_empty((n, h // stride, wd // stride, c),
                       dtype=torch.int8 if requant else torch.float32)


@torch.library.custom_op(f'{NAMESPACE}::qconv3x3_s8', mutates_args=())
def _qconv3x3_op(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                 b: torch.Tensor, colsum: torch.Tensor, scalars: torch.Tensor, act: str,
                 stride: int, requant: bool) -> torch.Tensor:
    return qconv.qconv3x3_s8(x, w, w_scale, b, colsum, act=act, stride=stride,
                             scalars=scalars, requant=requant)


@_qconv3x3_op.register_fake
def _(x, w, w_scale, b, colsum, scalars, act, stride, requant):
    n, h, wd, _ = x.shape
    return x.new_empty((n, h // stride, wd // stride, w.shape[0]),
                       dtype=torch.int8 if requant else torch.float32)


@torch.library.custom_op(f'{NAMESPACE}::qgconv3x3_s8', mutates_args=())
def _qgconv3x3_op(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                  b: torch.Tensor, colsum: torch.Tensor, scalars: torch.Tensor, act: str,
                  stride: int, requant: bool) -> torch.Tensor:
    return qconv.qgconv3x3_s8(x, w, w_scale, b, colsum, act=act, stride=stride,
                              scalars=scalars, requant=requant)


@_qgconv3x3_op.register_fake
def _(x, w, w_scale, b, colsum, scalars, act, stride, requant):
    n, h, wd, c = x.shape
    return x.new_empty((n, h // stride, wd // stride, c),
                       dtype=torch.int8 if requant else torch.float32)


@torch.library.custom_op(f'{NAMESPACE}::decode_heads', mutates_args=())
def _decode_heads_op(raws: List[torch.Tensor], num_classes: int, strides: List[int],
                     exp_caps: List[float]) -> torch.Tensor:
    return decode_kernel.decode_heads(raws, num_classes, strides, exp_caps)


@_decode_heads_op.register_fake
def _(raws, num_classes, strides, exp_caps):
    ch = 5 + num_classes
    rows = sum(r.shape[1] * r.shape[2] * (r.shape[3] // ch) for r in raws)
    return raws[0].new_empty((raws[0].shape[0], rows, ch), dtype=torch.float32)


@torch.library.custom_op(f'{NAMESPACE}::int8_sandwich', mutates_args=())
def _int8_sandwich_op(srcs: List[torch.Tensor], scalars: torch.Tensor, form: str,
                      act: str) -> torch.Tensor:
    return qconv.int8_sandwich(srcs, scalars, form=form, act=act)


@_int8_sandwich_op.register_fake
def _(srcs, scalars, form, act):
    n, h, w, c = srcs[0].shape
    if form == 'route':
        c = sum(t.shape[3] for t in srcs)
    return srcs[0].new_empty((n, h, w, c), dtype=torch.int8)


def qconv1x1_s8(x, w, w_scale, b, colsum, *, act: str, scalars, requant: bool):
    """``ops.qconv.qconv1x1_s8`` through ``torch.ops.pqdet``."""
    return torch.ops.pqdet.qconv1x1_s8(x, w, w_scale, b, colsum, scalars, act, requant)


def qdwconv3x3_s8(x, w, w_scale, b, *, act: str, stride: int, scalars, requant: bool):
    """``ops.qconv.qdwconv3x3_s8`` through ``torch.ops.pqdet``."""
    return torch.ops.pqdet.qdwconv3x3_s8(x, w, w_scale, b, scalars, act, stride, requant)


def qconv3x3_s8(x, w, w_scale, b, colsum, *, act: str, stride: int, scalars,
                requant: bool):
    """``ops.qconv.qconv3x3_s8`` through ``torch.ops.pqdet``."""
    return torch.ops.pqdet.qconv3x3_s8(x, w, w_scale, b, colsum, scalars, act, stride,
                                       requant)


def qgconv3x3_s8(x, w, w_scale, b, colsum, *, act: str, stride: int, scalars,
                 requant: bool):
    """``ops.qconv.qgconv3x3_s8`` through ``torch.ops.pqdet``."""
    return torch.ops.pqdet.qgconv3x3_s8(x, w, w_scale, b, colsum, scalars, act, stride,
                                        requant)


def decode_heads(raws: Sequence[torch.Tensor], num_classes: int, strides: Sequence[int],
                 exp_caps: Sequence[float]) -> torch.Tensor:
    """``ops.decode_kernel.decode_heads`` through ``torch.ops.pqdet``."""
    return torch.ops.pqdet.decode_heads(list(raws), num_classes, [int(s) for s in strides],
                                        [float(c) for c in exp_caps])


def int8_sandwich(srcs: Sequence[torch.Tensor], scalars, *, form: str, act: str = 'linear'):
    """``ops.qconv.int8_sandwich`` through ``torch.ops.pqdet``."""
    return torch.ops.pqdet.int8_sandwich(list(srcs), scalars, form, act)


class Kernels(NamedTuple):
    """The int8 walk's kernel entries (``Int8Inference.apply``), each with
    the wrappers' signature."""
    qconv1x1: object
    qdwconv3x3: object
    decode: object
    sandwich: object
    qconv3x3: object
    qgconv3x3: object


OPS = Kernels(qconv1x1_s8, qdwconv3x3_s8, decode_heads, int8_sandwich, qconv3x3_s8,
              qgconv3x3_s8)
WRAPPERS = Kernels(qconv.qconv1x1_s8, qconv.qdwconv3x3_s8, decode_kernel.decode_heads,
                   qconv.int8_sandwich, qconv.qconv3x3_s8, qconv.qgconv3x3_s8)
PLAIN = Kernels(qconv.qconv1x1_reference, qconv.qdwconv3x3_reference,
                decode_kernel.decode_heads_reference, qconv.int8_sandwich_reference,
                qconv.qconv3x3_reference, qconv.qgconv3x3_reference)


def graph_ops(graph_module) -> List[str]:
    """The ``pqdet`` operators a traced graph calls, one entry per call."""
    return [str(n.target) for n in graph_module.graph.nodes
            if n.op == 'call_function' and str(n.target).startswith(f'{NAMESPACE}.')]
