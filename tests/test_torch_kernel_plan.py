"""The launch plans of the port's redesigned CUDA kernels, checked on the
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
  empty, shared memory fits, the warp tiles are what the kernel takes;
- ``plan_qdwconv3x3`` at the 13 depthwise shapes of the int8 graph, B=1 and
  B=4, and at edge shapes (C 27, 75, 20, W not a multiple of the tile, a
  2x2 stride-2 input, C 1280): the tiles cover every output pixel and
  channel exactly once, each tile's window holds every tap of its
  outputs, the threads' units cover the tile once, the copies divide C,
  and the shared memory is the C side's layout (``dwlayout`` in
  csrc/qconv.cu) and fits;
- ``plan_qconv3x3`` at YOLOv3's 10 dense 3x3 shapes at 608 (the 37 convs
  it takes), B=1 and 32: the tiles cover the output, the shared memory is
  the C side's layout (``c3layout`` in csrc/qconv.cu) and fits two CTAs
  an SM;
- all three at every shape of mobilenetv2-fpn pruned at ratio 0.3
  (``test_torch_prune.pruned_mobilenetv2_cfg``), B=1, 4 and 16, at input
  sizes 320-608: widths of a multiple of 8 and not of 16 (a half-filled
  16-channel E block, the int8 kernels' 8-byte copies).
"""

import functools

import numpy as np
import pytest

from pqdet_tpu_torch.compress.quantized import conv_route, im2col_depth
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.ops.fused_ir import (FusedIrPlan, find_fused_triples,
                                          fused_ir_smem_bytes, plan_fused_ir)
from pqdet_tpu_torch.ops.fused_ir import SMEM_TWO
from pqdet_tpu_torch.ops.qconv import (C3_BM, DW_PX, DW_THREADS, plan_qconv1x1,
                                       plan_qconv3x3, plan_qdwconv3x3, plan_qgconv3x3,
                                       qconv1x1_smem_bytes, qconv3x3_smem_bytes,
                                       qdwconv3x3_smem_bytes, qgconv3x3_smem_bytes)
from pqdet_tpu_torch.zoo import get_cfg

SMEM_MAX = 232448
SIZE = 512


@functools.lru_cache(maxsize=None)
def chain_shapes(cfg=None, size=SIZE):
    """(h, cin, e, p, expand) of each fused chain of ``cfg`` (mobilenetv2-fpn
    by default) at ``size``."""
    net = DetectionNetwork.from_cfg(cfg or get_cfg('mobilenetv2-fpn'))
    nodes = {n.index: n for n in net.graph.nodes}
    out = []
    for a, b, c in find_fused_triples(net.graph):
        nb, nc = nodes[b], nodes[c]
        cin = nodes[a].in_channels if a is not None else nb.in_channels
        out.append((size // nb.stride, cin, nb.in_channels, nc.out_channels, a is not None))
    return out


@functools.lru_cache(maxsize=None)
def pointwise_shapes(cfg=None, size=SIZE):
    """Sorted (h, K, N) the 1x1 kernel sees in the int8 graph of ``cfg`` at
    ``size``."""
    net = DetectionNetwork.from_cfg(cfg or get_cfg('mobilenetv2-fpn'), quant=True)
    shapes = set()
    for n in net.graph.nodes:
        if n.kind != 'convolutional':
            continue
        a = n.attrs
        h = size * a['stride'] // n.stride
        route = conv_route(a, n.in_channels)
        if route == 'pw':
            shapes.add((h, n.in_channels, a['filters']))
        elif route == 'im2col':                      # the stem, as im2col patches
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


@functools.lru_cache(maxsize=None)
def depthwise_shapes(cfg=None, size=SIZE):
    """Sorted (h, c, stride) the depthwise kernel sees in the int8 graph of
    ``cfg`` at ``size``."""
    net = DetectionNetwork.from_cfg(cfg or get_cfg('mobilenetv2-fpn'), quant=True)
    return sorted({(size * n.attrs['stride'] // n.stride, n.in_channels, n.attrs['stride'])
                   for n in net.graph.nodes if n.kind == 'convolutional'
                   and n.attrs['size'] == 3 and n.attrs['groups'] == n.in_channels > 1})


def dwlayout(th, tw, cs, stride):
    """csrc/qconv.cu ``dwlayout``, line for line: the window rows padded to
    128 bytes and skewed, then s8 weights [9][cs], f32 w_scale and bias
    [cs], then the staged codes in th skewed rows; None for a plan the
    kernel refuses."""
    def pow2(v):
        return v > 0 and v & (v - 1) == 0
    if not (pow2(th) and th <= 64 and pow2(tw) and 4 <= tw <= 64 and pow2(cs)
            and 4 <= cs <= 256):
        return None
    wr, wc = (th - 1) * stride + 3, (tw - 1) * stride + 3
    skew = (cs if stride == 1 else cs // 2) % 128
    rp = (wc * cs + 127) // 128 * 128 + (skew if skew > 16 else 16)
    assert rp % 16 == 0                      # 16-byte copies into every row
    off_w = wr * rp
    off_ab = off_w + (9 * cs + 15) // 16 * 16
    buf = off_ab + 8 * cs
    sp = tw * cs + (cs % 128 if cs % 128 > 16 else 16)
    assert off_w % 16 == 0 and off_ab % 16 == 0 and buf % 16 == 0 and sp % 16 == 0
    return buf + th * sp


def check_dw_plan(n, h, w, c, stride):
    plan = plan_qdwconv3x3(n, h, w, c, stride)
    th, tw, cs, cw = plan.th, plan.tw, plan.cs, plan.cw
    ho, wo = h // stride, w // stride
    assert plan.smem == dwlayout(th, tw, cs, stride) == qdwconv3x3_smem_bytes(th, tw, cs, stride)
    assert plan.smem <= SMEM_MAX
    assert cw in (16, 8, 4, 1) and c % cw == 0 and cw <= cs
    # tiles cover every output pixel once, slices every channel once
    assert plan.tiles_x == -(-wo // tw) and plan.tiles_y == -(-ho // th)
    cover = np.zeros((ho, wo), np.int32)
    for ty in range(plan.tiles_y):
        for tx in range(plan.tiles_x):
            oy0, ox0 = ty * th, tx * tw
            cover[oy0:oy0 + th, ox0:ox0 + tw] += 1
            # the window [oy0*s-1, +wr) x [ox0*s-1, +wc) holds every tap
            wr, wc = (th - 1) * stride + 3, (tw - 1) * stride + 3
            taps_y = [oy * stride - 1 + k for oy in range(oy0, oy0 + th) for k in range(3)]
            taps_x = [ox * stride - 1 + k for ox in range(ox0, ox0 + tw) for k in range(3)]
            assert min(taps_y) == oy0 * stride - 1 and max(taps_y) < oy0 * stride - 1 + wr
            assert min(taps_x) == ox0 * stride - 1 and max(taps_x) < ox0 * stride - 1 + wc
    assert (cover == 1).all()
    _check_slices(c, cs, plan.slices, allow_empty=False)
    # one CTA a tile (the C entry point refuses another grid)
    assert plan.grid == n * plan.tiles_y * plan.tiles_x * plan.slices
    # the units (1 row x 4 columns x 4 channels, 1 where C % 4) cover the
    # tile once
    v = 4 if c % 4 == 0 else 1
    units = (cs // v) * th * (tw // DW_PX)
    assert units * v * DW_PX == th * tw * cs and units <= 16 * DW_THREADS
    return plan


def test_depthwise_shapes_are_the_13():
    shapes = depthwise_shapes()
    assert len(shapes) == 13
    assert (256, 96, 2) in shapes and (16, 960, 1) in shapes


@pytest.mark.parametrize('b', [1, 4])
@pytest.mark.parametrize('i', range(13))
def test_plan_qdwconv3x3_graph_shape(i, b):
    h, c, stride = depthwise_shapes()[i]
    plan = check_dw_plan(b, h, h, c, stride)
    assert plan.cw == 16                     # the graph's C are multiples of 16
    if b == 4:                               # two CTAs an SM, or the whole image
        assert plan.grid >= 128                  # about one CTA an SM, or more


@pytest.mark.parametrize('n,h,w,c,stride', [
    (1, 64, 64, 27, 1), (4, 64, 64, 27, 2),     # C odd: byte copies, 1 channel a thread
    (1, 64, 64, 75, 1), (4, 64, 64, 75, 2),
    (1, 64, 64, 20, 1), (4, 64, 64, 20, 2),     # C % 16 == 4: 4-byte copies
    (2, 20, 36, 32, 1), (2, 20, 36, 96, 2),     # W not a multiple of the tile
    (1, 2, 2, 20, 2), (2, 2, 2, 32, 2),         # a 2x2 input at stride 2
    (1, 16, 16, 1280, 1), (4, 16, 16, 1280, 1),
    (1, 5, 7, 6, 1), (3, 9, 13, 8, 1),
])
def test_plan_qdwconv3x3_edges(n, h, w, c, stride):
    check_dw_plan(n, h, w, c, stride)


def test_plan_qdwconv3x3_refuses():
    with pytest.raises(ValueError, match='empty'):
        plan_qdwconv3x3(1, 4, 4, 0, 1)
    with pytest.raises(ValueError, match='even H/W'):
        plan_qdwconv3x3(1, 5, 4, 8, 2)


PRUNED_SIZES = tuple(range(320, 609, 32))


def _pruned_cfg():
    from test_torch_prune import pruned_mobilenetv2_cfg
    return pruned_mobilenetv2_cfg(0.3)


def test_pruned_shapes_cover_widths_of_8_mod_16():
    """The pruned graph has fused chains with E = 8 (mod 16), pointwise K
    and N and depthwise C = 8 (mod 16), which the unpruned graph has not."""
    cfg = _pruned_cfg()
    chains = chain_shapes(cfg)
    assert 0 < len(chains) < 21
    assert any(e % 16 == 8 for _, _, e, _, _ in chains)
    assert not any(e % 16 for _, _, e, _, _ in chain_shapes())
    pw = pointwise_shapes(cfg)
    assert any(k % 16 == 8 for _, k, _ in pw) and any(n % 16 == 8 for _, _, n in pw)
    assert any(c % 16 == 8 for _, c, _ in depthwise_shapes(cfg))


@pytest.mark.parametrize('n', [1, 4, 16])
def test_plan_fused_ir_pruned(n):
    cfg = _pruned_cfg()
    for size in PRUNED_SIZES:
        for h, cin, e, p, expand in chain_shapes(cfg, size):
            check_fused_plan(plan_fused_ir(n, h, h, cin, e, p, expand), n, h, h, cin, e, p,
                             expand)


@pytest.mark.parametrize('b', [1, 4, 16])
def test_plan_qconv1x1_pruned(b):
    cfg = _pruned_cfg()
    for size in PRUNED_SIZES:
        for h, k, n in pointwise_shapes(cfg, size):
            check_qconv_plan(b * h * h, k, n)


@pytest.mark.parametrize('b', [1, 4, 16])
def test_plan_qdwconv3x3_pruned(b):
    cfg = _pruned_cfg()
    for size in PRUNED_SIZES:
        for h, c, stride in depthwise_shapes(cfg, size):
            plan = check_dw_plan(b, h, h, c, stride)
            assert plan.cw == (16 if c % 16 == 0 else 8)


REGNETS = ('regnetx-600m-fpn', 'regnetx-600m-pan', 'regnetx-600m-rpan', 'regnetx-600m-yolo',
           'regnety-400m-fpn')


@functools.lru_cache(maxsize=None)
def regnet_int8_shapes(name):
    """chip_smoke's int8 conv shapes of the RegNet's int8 graph at SIZE:
    the grouped 3x3s as the grouped 3x3 kernel's (group width in Cout's
    place), the SE 1x1s at H = W = 1, the strided 1x1 projections on every
    other pixel."""
    import chip_smoke
    return chip_smoke.int8_conv_shapes(DetectionNetwork.from_cfg(get_cfg(name), quant=True), SIZE)


@pytest.mark.parametrize('b', [1, 4, 16])
@pytest.mark.parametrize('name', REGNETS)
def test_plan_regnet_int8_shapes(name, b):
    """Every int8 conv shape of the five RegNet detectors at 512 plans within
    the kernels' limits: the 1x1 kernel at K up to 1024 and M = B (SE), the
    grouped 3x3 kernel at Cin up to 528 (its shared memory the layout's,
    within a CTA's 232,448 bytes), the depthwise kernel at C 128-512
    (regnetx-600m-yolo)."""
    ks, gs = [], []
    for (kind, h, w, k, n, stride, _, _), _ in regnet_int8_shapes(name).items():
        if kind == 'dw':
            check_dw_plan(b, h, w, k, stride)
        elif kind == 'g3':
            plan = plan_qgconv3x3(b, h, w, k, n, stride)
            assert plan.smem == qgconv3x3_smem_bytes(plan.th, plan.tw, plan.g, n, stride,
                                                     plan.stages) <= SMEM_MAX
            assert plan.g * n <= k and plan.tiles >= b
            gs.append(k)
        else:
            check_qconv_plan(b * h * w, k, n)
            ks.append(k)
    wide = {'regnetx-600m-fpn': 528, 'regnetx-600m-yolo': 1024, 'regnety-400m-fpn': 440}
    assert max(ks) == wide.get(name, 704)
    assert max(gs) == (440 if name == 'regnety-400m-fpn' else 528)


def test_plan_qconv1x1_at_the_widest_densified_conv():
    """The widest densified conv the zoo's RegNets had before their grouped
    3x3s took the grouped kernel (Cin 528 at 16x16, B=4): 128 x 32 tiles,
    38 K steps of 128, 136 CTAs without split-K."""
    plan = check_qconv_plan(4 * 16 * 16, 9 * 528, 528)
    assert (plan.bm, plan.bn, plan.bk, plan.split) == (128, 32, 128, 1)
    assert -(-4752 // plan.bk) == 38 and plan.m_blocks * plan.n_blocks == 136


@pytest.mark.parametrize('n', [1, 4, 16])
def test_plan_fused_ir_regnet_yolo(n):
    """regnetx-600m-yolo's nine chains (Cin 224-1024, E 128-512, P
    256-1024, two bare pairs) plan within the kernel's limits."""
    chains = chain_shapes(get_cfg('regnetx-600m-yolo'))
    assert len(chains) == 9 and sum(not ex for *_, ex in chains) == 2
    assert {e for _, _, e, _, _ in chains} == {128, 256, 512}
    for h, cin, e, p, expand in chains:
        check_fused_plan(plan_fused_ir(n, h, h, cin, e, p, expand), n, h, h, cin, e, p, expand)


@functools.lru_cache(maxsize=None)
def nas_candidate_cfgs():
    """The cfg texts of ``generate_candidates(8, seed=0)`` (20 classes)."""
    from pqdet_tpu_torch.nas.search import generate_candidates
    return tuple(cfg for cfg, _ in generate_candidates(8, seed=0, device='cpu'))


@pytest.mark.parametrize('n', [1, 4, 16])
@pytest.mark.parametrize('size', [352, 512])
def test_plan_fused_ir_nas_candidates(size, n):
    """Every fused chain of the eight seed-0 NAS candidates at the NAS
    yamls' eval size 352 (ragged 11x11 and 22x22 grids) and at 512: group
    width 1 heads fuse 1x1 -> dw 3x3 -> 1x1 at E 32-144, below any zoo
    chain."""
    chains = [c for cfg in nas_candidate_cfgs() for c in chain_shapes(cfg, size)]
    assert len(nas_candidate_cfgs()) == 8 and len(chain_shapes(nas_candidate_cfgs()[1])) == 12
    assert {32, 112, 144} <= {e for _, _, e, _, _ in chains}
    assert {size // s for s in (8, 16, 32)} == {h for h, *_ in chains}
    for h, cin, e, p, expand in chains:
        check_fused_plan(plan_fused_ir(n, h, h, cin, e, p, expand), n, h, h, cin, e, p, expand)


@pytest.mark.parametrize('n', [1, 4, 16])
def test_plan_fused_ir_mobilenet_at_352(n):
    """mobilenetv2-fpn's 21 chains at the evolution yaml's eval size 352
    (grids 88/44/22/11)."""
    chains = chain_shapes(size=352)
    assert len(chains) == 21 and {h for h, *_ in chains} == {11, 22, 44, 88}
    for h, cin, e, p, expand in chains:
        check_fused_plan(plan_fused_ir(n, h, h, cin, e, p, expand), n, h, h, cin, e, p, expand)


# VisDrone's eval inputs: each of its four resolutions resized by 1.25 and
# padded to a multiple of 32 (h, w)
VISDRONE_INPUTS = [(1888, 2528), (1376, 2400), (960, 1728), (704, 1216)]


@pytest.mark.parametrize('hw', VISDRONE_INPUTS)
def test_plan_qconv1x1_at_visdrone_sizes(hw):
    """Every 1x1 and im2col shape of regnetx-600m-fpn's int8 graph at a
    VisDrone eval input (B=1, non-square) plans within the kernel's limits,
    and every grouped 3x3 within the grouped kernel's; the stem's im2col at
    2528x1888 is the largest M, 944 x 1264 rows, well inside the kernel's
    32-bit rows, which the plan rule refuses past."""
    import chip_smoke
    from pqdet_tpu_torch.ops.qconv import MAX_M
    net = DetectionNetwork.from_cfg(get_cfg('regnetx-600m-fpn'), quant=True)
    shapes = chip_smoke.int8_conv_shapes(net, hw)
    ms = []
    for (kind, h, w, k, n, stride, *_), _ in shapes.items():
        assert kind in ('pw', 'im2col', 'g3')
        if kind == 'g3':
            assert plan_qgconv3x3(1, h, w, k, n, stride).smem <= SMEM_MAX
            continue
        check_qconv_plan(h * w, k, n)
        ms.append(h * w)
    assert max(ms) == (hw[0] // 2) * (hw[1] // 2)
    assert any(h != w for _, h, w, *_ in shapes)
    with pytest.raises(ValueError, match='rows, over the kernel'):
        plan_qconv1x1(MAX_M + 1, 32, 32)


def c3layout(bn, stages):
    """csrc/qconv.cu ``c3layout``, line for line: 1024 bytes of alignment
    slack, ``stages`` slots of an A tile [128][128] and a B tile [bn][128],
    then f32 alpha and beta [bn]; None for a plan the kernel refuses."""
    if bn not in (64, 128) or not 3 <= stages <= 6:
        return None
    return 1024 + stages * (128 * 128 + bn * 128) + 8 * bn


@functools.lru_cache(maxsize=None)
def dense_3x3_shapes(cfg_text, size):
    """Sorted (side_in, cin, cout, stride) of the dense 3x3s that
    qconv3x3_s8 takes in the int8 graph of ``cfg_text`` at ``size``."""
    net = DetectionNetwork.from_cfg(cfg_text, quant=True)
    return sorted({(size * n.attrs['stride'] // n.stride, n.in_channels, n.attrs['filters'],
                    n.attrs['stride']) for n in net.graph.nodes
                   if n.kind == 'convolutional' and conv_route(n.attrs, n.in_channels) == 'c3'})


def test_yolov3_dense_3x3_shapes_are_the_10():
    shapes = dense_3x3_shapes(get_cfg('yolov3', num_classes=80), 608)
    assert len(shapes) == 10
    assert {s[1] for s in shapes} == {32, 64, 128, 256, 512}
    assert (608, 32, 64, 2) in shapes and (19, 512, 1024, 1) in shapes


@pytest.mark.parametrize('b', [1, 32])
@pytest.mark.parametrize('i', range(10))
def test_plan_qconv3x3_at_yolov3(i, b):
    """Each of YOLOv3's 10 admitted shapes at 608, B=1 and the cell's 32: the
    tiles cover the output pixels and channels, the shared memory is the C
    side's layout and fits two CTAs on an SM, the rule's tile width."""
    side, cin, cout, stride = dense_3x3_shapes(get_cfg('yolov3', num_classes=80), 608)[i]
    plan = plan_qconv3x3(b, side, side, cin, cout, stride)
    m = b * (side // stride) ** 2
    assert plan.m_blocks == -(-m // C3_BM) and plan.n_blocks == -(-cout // plan.bn)
    assert (plan.m_blocks - 1) * C3_BM < m and (plan.n_blocks - 1) * plan.bn < cout
    assert plan.smem == qconv3x3_smem_bytes(plan.bn, plan.stages) == c3layout(plan.bn,
                                                                               plan.stages)
    assert plan.smem <= SMEM_TWO
    assert plan.bn == (64 if cout <= 64 else 128)
    assert plan.c_args == (plan.bn, plan.stages, plan.smem)


def test_plan_qconv3x3_refuses():
    with pytest.raises(ValueError, match='multiple of 16'):
        plan_qconv3x3(1, 8, 8, 40, 32, 1)
    with pytest.raises(ValueError, match='even'):
        plan_qconv3x3(1, 7, 8, 32, 32, 2)
    with pytest.raises(ValueError, match='empty'):
        plan_qconv3x3(0, 8, 8, 32, 32, 1)
    with pytest.raises(ValueError, match='32-bit'):
        plan_qconv3x3(64, 1024, 1024, 32, 32, 1)
