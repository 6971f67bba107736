"""The launch plans of the port's two redesigned CUDA kernels, checked on the
CPU (the kernels themselves run only on the card, in chip_smoke.py):

- ``plan_fused_ir`` at the 21 fused chains of mobilenetv2-fpn at 512x512
  (``find_fused_triples``), B=1, 4 and 64, and at ragged 13x13 and 20x12
  inputs: pixel tiles, E slices and P slices and chunks cover every output
  pixel and channel exactly once, shared memory fits, the cluster is at
  most 8 and divides the grid, the 16x16 and 32x32 chains run at least 128
  CTAs at B=4, and the plan stays within the kernel's per-thread copy and
  warp-unit limits (``layout`` in csrc/fused_ir.cu);
- ``plan_qconv1x1`` at the 34 pointwise shapes of the int8 graph (33 1x1
  convs and the stem's im2col), B=1 and B=4, and at edge shapes: the tiles
  cover M and N, the split-K ranks cover the K steps exactly once with none
  empty, shared memory fits, the warp tiles are what the kernel takes.
"""

import functools

import numpy as np
import pytest

from pqdet_tpu_torch.compress.quantized import im2col_depth
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.ops.fused_ir import (FusedIrPlan, find_fused_triples,
                                          fused_ir_smem_bytes, plan_fused_ir)
from pqdet_tpu_torch.ops.qconv import plan_qconv1x1, qconv1x1_smem_bytes
from pqdet_tpu_torch.zoo import get_cfg

SMEM_MAX = 232448
SIZE = 512


@functools.lru_cache(maxsize=None)
def chain_shapes():
    """(h, cin, e, p, expand) of each fused chain at SIZE."""
    net = DetectionNetwork.from_cfg(get_cfg('mobilenetv2-fpn'))
    nodes = {n.index: n for n in net.graph.nodes}
    out = []
    for a, b, c in find_fused_triples(net.graph):
        nb, nc = nodes[b], nodes[c]
        cin = nodes[a].in_channels if a is not None else nb.in_channels
        out.append((SIZE // nb.stride, cin, nb.in_channels, nc.out_channels, a is not None))
    return out


@functools.lru_cache(maxsize=None)
def pointwise_shapes():
    """Sorted (h, K, N) the 1x1 kernel sees in the int8 graph at SIZE."""
    net = DetectionNetwork.from_cfg(get_cfg('mobilenetv2-fpn'), quant=True)
    shapes = set()
    for n in net.graph.nodes:
        if n.kind != 'convolutional':
            continue
        a = n.attrs
        h = SIZE * a['stride'] // n.stride
        if a['size'] == 1:
            shapes.add((h, n.in_channels, a['filters']))
        elif a['groups'] == 1:                       # the stem, as im2col patches
            shapes.add((h // a['stride'], im2col_depth(n.in_channels), a['filters']))
    return sorted(shapes)


def _r16(v):
    return -(-v // 16) * 16


def _r32(v):
    return -(-v // 32) * 32


def _check_slices(size, step, ranks, allow_empty):
    """[r*step, (r+1)*step) cut to size cover [0, size) exactly once."""
    seen = np.zeros(size, np.int32)
    for r in range(ranks):
        lo, hi = r * step, min(size, (r + 1) * step)
        assert allow_empty or hi > lo, f'rank {r} of {ranks} has an empty slice'
        seen[lo:max(lo, hi)] += 1
    assert (seen == 1).all()


def check_fused_plan(plan: FusedIrPlan, n, h, w, cin, e, p, expand):
    th, tw, cl = plan.th, plan.tw, plan.cluster
    # pixel tiles
    tiles_x, tiles_y = -(-w // tw), -(-h // th)
    assert plan.tiles == tiles_x * tiles_y
    cover = np.zeros((h, w), np.int32)
    for tile in range(plan.tiles):
        y0, x0 = (tile // tiles_x) * th, (tile % tiles_x) * tw
        cover[y0:y0 + th, x0:x0 + tw] += 1
    assert (cover == 1).all()
    # E slices (none empty), P slices and their chunks
    assert plan.es % 16 == 0
    _check_slices(e, plan.es, cl, allow_empty=False)
    assert plan.ps % 8 == 0 and 8 <= plan.pn <= 128 and plan.pn % 8 == 0
    _check_slices(p, plan.ps, cl, allow_empty=True)
    for r in range(cl):
        p_n = max(0, min(p - r * plan.ps, plan.ps))
        _check_slices(p_n, plan.pn, -(-p_n // plan.pn), allow_empty=False)
    # cluster, grid, shared memory
    assert 1 <= cl <= 8 and (plan.tiles * cl) % cl == 0
    assert plan.stages in (2, 3)
    assert plan.smem == fused_ir_smem_bytes(th, tw, cl, plan.es, plan.ps, plan.ck, plan.pn,
                                            plan.stages, expand, plan.reduce)
    if plan.reduce:                     # ranks add partials over all of P
        assert cl > 1 and plan.ps == p
    assert plan.smem <= SMEM_MAX
    # the kernel's own limits (layout() in csrc/fused_ir.cu)
    npix, mw = th * tw, _r16((th + 2) * (tw + 2))
    assert npix % 16 == 0
    if expand:
        ec = _r32(min(plan.es, 64))
        assert plan.ck in (32, 64, 128)
        assert mw // 16 * 2 <= 24 and mw * plan.ck // 8 <= 8 * 256
        assert plan.ck * ec // 8 <= 4 * 256
        assert (mw * (plan.ck + 8) + plan.ck * (ec + 8)) * 2 < 65536
    else:
        assert plan.ck == 0
    assert 64 * _r32(plan.pn) // 8 <= 4 * 256 and npix * 64 // 8 <= 4 * 256
    assert npix // 16 * (_r32(plan.pn) // 32) <= 24


def test_fused_chain_shapes_are_the_21():
    shapes = chain_shapes()
    assert len(shapes) == 21
    assert {h for h, *_ in shapes} == {16, 32, 64, 128}


@pytest.mark.parametrize('n', [1, 4, 64])
@pytest.mark.parametrize('i', range(21))
def test_plan_fused_ir_chain(i, n):
    h, cin, e, p, expand = chain_shapes()[i]
    plan = plan_fused_ir(n, h, h, cin, e, p, expand)
    check_fused_plan(plan, n, h, h, cin, e, p, expand)
    if n == 4 and h <= 32:
        assert plan.tiles * plan.cluster * n >= 128


@pytest.mark.parametrize('n', [1, 4])
@pytest.mark.parametrize('h,w,cin,e,p,expand', [
    (13, 13, 24, 144, 24, True),
    (13, 13, 32, 144, 160, True),
    (20, 12, 24, 144, 1024, True),
    (20, 12, 128, 128, 160, False),
    (13, 13, 1280, 512, 1024, True),
])
def test_plan_fused_ir_ragged(h, w, cin, e, p, expand, n):
    check_fused_plan(plan_fused_ir(n, h, w, cin, e, p, expand), n, h, w, cin, e, p, expand)


def test_plan_fused_ir_rejects_an_empty_shape():
    with pytest.raises(ValueError, match='empty'):
        plan_fused_ir(1, 0, 8, 16, 16, 16)


def check_qconv_plan(m, k, n):
    plan = plan_qconv1x1(m, k, n)
    bm, bn, bk = plan.bm, plan.bn, plan.bk
    assert bm in (64, 128) and bk in (32, 64, 128) and plan.stages in (2, 3)
    # the tiles cover M and N, the last tile of each only partly
    assert plan.m_blocks == -(-m // bm) and plan.n_blocks == -(-n // bn)
    # split-K: whole K steps, every rank some, all covered once
    ksteps = -(-k // bk)
    assert 1 <= plan.split <= 8
    _check_slices(ksteps, plan.kpr, plan.split, allow_empty=False)
    # the warp tile the kernel takes: 32 rows x 16 or 32 columns
    wtile = bn // (8 // (bm // 32))
    assert bn % 32 == 0 and wtile % 16 == 0 and wtile <= 32
    assert plan.smem == qconv1x1_smem_bytes(bm, bn, bk, plan.stages) <= SMEM_MAX
    return plan


def test_pointwise_shapes_are_the_34():
    shapes = pointwise_shapes()
    assert len(shapes) == 34
    assert (256, 32, 32) in shapes          # the stem: 9 * 3 = 27 taps padded to 32


@pytest.mark.parametrize('b', [1, 4])
@pytest.mark.parametrize('i', range(34))
def test_plan_qconv1x1_graph_shape(i, b):
    h, k, n = pointwise_shapes()[i]
    plan = check_qconv_plan(b * h * h, k, n)
    if b == 4 and h == 16:                  # the 16x16 layers fill the card by split-K
        assert plan.m_blocks * plan.n_blocks * plan.split >= 128


@pytest.mark.parametrize('m,k,n', [
    (15, 64, 96),          # M below one tile
    (4 * 81, 160, 75),     # M not a multiple of the tile, N 75
    (4 * 64 * 64, 27, 32),  # the raw stem K
    (4 * 77, 1280, 512),   # split-K with a ragged M
    (1, 16, 16),
])
def test_plan_qconv1x1_edges(m, k, n):
    check_qconv_plan(m, k, n)


def test_im2col_depth_pads_to_16():
    assert [im2col_depth(c) for c in (1, 2, 3, 16)] == [16, 32, 32, 144]
