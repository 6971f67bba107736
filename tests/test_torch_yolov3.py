"""YOLOv3 with its Darknet-53 backbone (``zoo/darknet.py``) in the port, and
the int8 route it forced: every dense 3x3 as im2col patches into
``qconv1x1_s8``, whose grid now holds more than 65,535 row tiles.

On the CPU, at the published widths and a 64x64 input: the graph's counts
and work, its text against the frozen benchmark cfg and the paper's table
(``benchmark/reference/yolov3.py``), the f32 walk and the int8 ``'int'``
mode against the benchmark's plain reference, the kernel mode's route
against a direct conv and against ``'int'`` mode, the walk's 3x3 routes,
span and patch bytes, and the 1x1 kernel's plans. On the card (marker ``cuda``, skipped
elsewhere; run there with ``python -m pytest --noconftest -m cuda
tests/test_torch_yolov3.py``): ``qconv1x1_s8`` past 65,535 row tiles and
every YOLOv3 dense 3x3 through the route, byte for byte against their
plain versions, and the whole bf16 and int8 serving walks at 608, B=2,
against the reference within the benchmark cell's limits.
"""

import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from benchmark import compare, counts, harness, weights
from benchmark.reference import cfg as C
from benchmark.reference import int8 as RQ
from benchmark.reference import net as RN
from benchmark.reference import yolov3 as RY
from pqdet_tpu_torch.compress.qat import QuantCtx, prepare_qat_state
from pqdet_tpu_torch.compress.quantized import (Int8Inference, _stem_im2col, convert_to_int8,
                                                im2col_depth)
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.ops.preprocess import device_normalize
from pqdet_tpu_torch.ops.qconv import (_epilogue, make_scalars, plan_qconv1x1,
                                       qconv1x1_reference, qconv1x1_s8, qconv3x3_reference)
from pqdet_tpu_torch.utils import tracing
from pqdet_tpu_torch.utils.profiling import count_macs_params
from pqdet_tpu_torch.zoo import MODEL_ZOO, get_cfg

CELL = 'yolov3-serve-int8-b32-608'
FROZEN = harness.ROOT / 'benchmark' / 'configs' / 'yolov3-608.cfg'
GAIN = json.loads(FROZEN.with_suffix('.json').read_text())['gain']
SIZE = 64


@pytest.fixture(scope='module', autouse=True)
def few_torch_threads():
    """Two intra-op threads for this module's convs, beside the suite's
    other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: qconv1x1_s8 runs only there')
    return torch.device('cuda', 0)


def yolov3_text():
    return get_cfg('yolov3', num_classes=80)


def paper_view(lay):
    """The facts of a ``reference/cfg.layers`` layer that the paper's table
    gives (``benchmark/reference/yolov3.py``)."""
    k = lay['kind']
    if k == 'convolutional':
        return {'kind': k, 'filters': lay['cout'], 'size': lay['size'],
                'stride': lay['stride'], 'bn': lay['bn'], 'act': lay['act']}
    if k == 'shortcut':
        return {'kind': k, 'refs': lay['refs'], 'act': lay['act']}
    if k == 'route':
        return {'kind': k, 'refs': lay['refs']}
    if k == 'upsample':
        return {'kind': k, 'stride': lay['stride']}
    return {'kind': k, 'classes': lay['classes']}


def dense_3x3(lays):
    return [l for l in lays if l['kind'] == 'convolutional' and l['size'] == 3]


def test_the_zoo_builds_the_published_graph():
    """107 layers (75 convs, 23 shortcuts, 4 routes, 2 upsamples, 3 yolo),
    61,949,149 parameters at 80 classes, 140.69 GFLOP an image at 608; 38
    dense 3x3s, 32 of them wider than Cin 115, holding 77.5 % of the work."""
    assert 'yolov3' in MODEL_ZOO
    net = DetectionNetwork.from_cfg(yolov3_text())
    kinds = [n.kind for n in net.graph.nodes]
    assert len(kinds) == 107
    assert {k: kinds.count(k) for k in set(kinds)} == {
        'convolutional': 75, 'shortcut': 23, 'route': 4, 'upsample': 2, 'yolo': 3}
    assert count_macs_params(net.graph, (608, 608))[1] == 61_949_149
    lays = C.layers(yolov3_text())
    ops = counts.forward_ops(lays, 608)
    assert round(ops / 1e9, 2) == 140.69
    dense = dense_3x3(lays)
    # wider than the JAX package's integer-exact dense 3x3s (Cin 115)
    wide = [l for l in dense if l['cin'] > 115]
    assert len(dense) == 38 and len(wide) == 32
    share = sum(counts.conv_ops(l, 608 // l['stride_total']) for l in wide) / ops
    assert round(100 * share, 1) == 77.5


def test_the_zoo_text_is_the_frozen_cfg_and_the_papers_table():
    """The generator's text is the benchmark's frozen cfg letter for letter,
    and its layers are the paper's Table 1 and yolov3.cfg's head."""
    text = yolov3_text()
    assert text == FROZEN.read_text()
    assert [paper_view(l) for l in C.layers(text)] == RY.layers(80)


def seeded(size=SIZE, b=2, seed=0):
    lays = C.layers(yolov3_text())
    params, state = weights.make(lays, torch.Generator().manual_seed(seed), GAIN, 'cpu')
    u8 = torch.randint(0, 256, (b, size, size, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(seed + 1))
    return lays, params, state, u8


def test_the_f32_walk_equals_the_reference():
    """The port's f32 walk (leaky 0.1, the ltrb decode) on the benchmark's
    seeded weights against the plain reference, each head channel within
    1e-4 of its scale; the scores spread."""
    lays, params, state, u8 = seeded()
    net = DetectionNetwork.from_cfg(yolov3_text())
    with torch.no_grad():
        port = net(params, state, device_normalize(u8), plain=True)
    ref = RN.infer(lays, params, state, RN.normalize(u8))
    assert port.shape == ref.shape == (2, 3 * (4 + 16 + 64), 85)
    scale = ref.abs().amax(dim=(0, 1))
    assert ((port - ref).abs().amax(dim=(0, 1)) / scale).max() < 1e-4
    assert float(ref[..., 4].std()) > 0.01


@pytest.fixture(scope='module')
def int8_model():
    """(lays, quant net, int8 qparams, normalized input, the reference's
    int8 model) after two observer passes on the same batch."""
    lays, params, state, u8 = seeded()
    qnet = DetectionNetwork.from_cfg(yolov3_text(), quant=True)
    qp, qs = prepare_qat_state(qnet, params, state)
    x = device_normalize(u8)
    with torch.no_grad():
        for _ in range(2):
            ctx = QuantCtx(qs['quant'], observing=True)
            qnet(qp, qs, x, quant_ctx=ctx)
            qs = {**qs, 'quant': ctx.new_obs}
        qparams = convert_to_int8(qnet, qp, qs)
    xr = RN.normalize(u8)
    model = RQ.convert(lays, params, state, RQ.calibrate(lays, params, state, [xr, xr]))
    return lays, qnet, qparams, x, model


def test_int_mode_equals_the_reference_integer_forward(int8_model):
    """``'int'`` mode against ``benchmark/reference/int8.py``: the edges'
    ranges agree (a range is an extreme, so codes rounded the other way
    upstream move a deep edge's by a few codes) and the scores within
    0.02."""
    lays, qnet, qparams, x, model = int8_model
    for edge, (s, zp) in model[1].items():
        ps, pzp = qparams['act'][edge]
        assert abs(s - ps) <= 3e-2 * ps and abs(zp - pzp) <= 3
    with torch.no_grad():
        port = Int8Inference(qnet, mode='int').apply(Int8Inference.prepare(qparams, mode='int'), x)
    ref = RQ.infer(lays, model, x).float()

    def scores(p):
        return p[..., 4:5] * p[..., 5:]
    assert (scores(port) - scores(ref)).abs().max() < 0.02


def test_kernel_mode_takes_every_dense_3x3_through_the_route(int8_model):
    """Kernel mode stages ``wim`` for the stem and ``w3`` for the 37 dense
    3x3s past it, at K up to 4608 (Cin 512: every 3x3 of width 1024 takes
    a 1x1's 512); at the plain walk's own input codes, each conv's route
    (the stem's patches into the 1x1 kernel's plain version, the others'
    ``qconv3x3_reference``) equals a direct float64 conv with the same
    epilogue byte for byte."""
    lays, qnet, qparams, x, _ = int8_model
    staged = Int8Inference.prepare(qparams, network=qnet)
    act, layers = qparams['act'], staged['layers']
    with torch.no_grad():
        _, inter = Int8Inference(qnet).apply(staged, x, intermediates=True, plain=True)
        ks = []
        for l in dense_3x3(lays):
            key, p = str(l['index']), layers[str(l['index'])]
            stem = l['index'] == 0
            view, colsum = (p['wim'], p['wim_colsum']) if stem else (p['w3'].t(), p['colsum'])
            assert view.shape == ((im2col_depth(3) if stem else 9 * l['cin']), l['cout'])
            ks.append(view.shape[0])
            src = 'input' if l['index'] == 0 else str(l['index'] - 1)
            sz = act[src]
            xq = (torch.round(device_normalize(x) / sz[0] + sz[1]) if l['index'] == 0
                  else torch.round(inter[src] / sz[0] + sz[1])).clamp(0, 255) - 128
            xq = xq.to(torch.int8)
            sc = make_scalars(sz[0], sz[1], *act[key], device='cpu')
            pad = round(sz[1]) - 128
            kw = dict(act='relu', scalars=sc, requant=True)
            route = qconv1x1_reference(_stem_im2col(xq, l['stride'], pad), p['wim'],
                                       p['w_scale'], p['b'], colsum, **kw) if stem else \
                qconv3x3_reference(xq, p['w3'], p['w_scale'], p['b'], colsum,
                                   stride=l['stride'], **kw)
            xp = F.pad(xq.double().permute(0, 3, 1, 2), (1,) * 4, value=float(pad))
            acc = F.conv2d(xp, p['wq'].double(), None, l['stride']).permute(0, 2, 3, 1).float()
            direct = _epilogue(acc, sc.reshape(-1), p['w_scale'], p['b'], colsum.float(),
                               'relu', True)
            assert torch.equal(route, direct), key
    assert max(ks) == 9 * 512 == 4608


def test_kernel_mode_agrees_with_int_mode_conv_by_conv(int8_model):
    """The plain kernel walk against the exact integer mode, each conv from
    the kernel walk's own input codes: the two epilogues round apart (an
    f32 bias term against a float64 sum), so codes are equal or one apart
    on under a 1e-5 share of them (``chip_smoke.int8_modes_agree``)."""
    import chip_smoke
    _, qnet, qparams, x, _ = int8_model
    n_conv, worst, n_diff, n_all, bad_heads = chip_smoke.int8_modes_conv_parity(qnet, qparams, x)
    assert n_conv == 75 and n_all > 10 ** 6
    assert chip_smoke.int8_modes_agree(worst, n_diff, n_all, bad_heads)


# dense 3x3s of Cin 128 and 144, past the 115 up to which the JAX package
# stages its integer-exact route (wider ones run its bf16 dequant conv)
WIDE_3X3_CFG = """[net]
channels=3

[convolutional]
filters=128
size=3
stride=2
pad=1
batch_normalize=1
activation=leaky

[convolutional]
filters=144
size=3
stride=1
pad=1
batch_normalize=1
activation=leaky

[convolutional]
filters=96
size=3
stride=2
pad=1
batch_normalize=1
activation=leaky

[convolutional]
filters=18
size=1
stride=1
pad=1
activation=linear

[yolo]
mask=0,1,2
anchors=10,13,16,30,33,23
classes=1
"""


def test_kernel_mode_takes_dense_3x3s_past_cin_115_exactly():
    """The port's departure from the JAX package, on a small graph: kernel
    mode (its kernels' plain versions on the CPU) stages ``w3`` for the
    dense 3x3s of Cin 128 and 144 and takes them through ``qconv3x3_s8``,
    with ``plain`` too (the stem's patches alone counted), and conv by conv
    it agrees with the exact integer mode (``int8_modes_agree``).
    That gate is a share of codes (the epilogues' roundings part on a few
    in a million), so the input is 64x64, B=2: 606,208 codes."""
    import chip_smoke
    net = DetectionNetwork.from_cfg(WIDE_3X3_CFG, quant=True)
    params, state = net.init(torch.Generator().manual_seed(0), device='cpu')
    params, state = prepare_qat_state(net, params, state)
    x = torch.rand((2, SIZE, SIZE, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ctx = QuantCtx(state['quant'], observing=True)
        net(params, state, x, quant_ctx=ctx)
        qparams = convert_to_int8(net, params, {**state, 'quant': ctx.new_obs})
        staged = Int8Inference.prepare(qparams, network=net)
        assert staged['layers']['0']['wim'].shape == (32, 128)
        assert [staged['layers'][k]['w3'].shape for k in '12'] == [(144, 9 * 128),
                                                                  (96, 9 * 144)]
        routes = Int8Inference(net).routes(qparams['act'])
        assert [routes[k] for k in '0123'] == ['im2col', 'c3', 'c3', 'pw']
        counted = []
        for plain in (False, True):
            tracing.clear()
            with profile(activities=[ProfilerActivity.CPU]):
                with tracing.span('root'):
                    Int8Inference(net).apply(staged, x, plain=plain)
            r = tracing.records()
            counted.append((sum(1 for s in r['spans'] if s[0] == 'int8.conv3x3'),
                            r['counters']['int8.im2col_bytes']))
    assert counted == [(3, 2 * SIZE ** 2 // 4 * 32)] * 2
    n_conv, worst, n_diff, n_all, bad_heads = chip_smoke.int8_modes_conv_parity(net, qparams, x)
    assert n_conv == 4 and n_all == 606_208
    assert chip_smoke.int8_modes_agree(worst, n_diff, n_all, bad_heads)


def conv3x3_counters(cfg_text, size=SIZE, plain=False):
    """The walk's 3x3 counts over one kernel-mode forward of seeded int8
    qparams: (int8.im2col_bytes, conv3x3 spans, 'c3' routes of the route
    table)."""
    net = DetectionNetwork.from_cfg(cfg_text, quant=True)
    params, state = net.init(torch.Generator().manual_seed(0), device='cpu')
    params, state = prepare_qat_state(net, params, state)
    x = torch.rand((1, size, size, 3), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ctx = QuantCtx(state['quant'], observing=True)
        net(params, state, x, quant_ctx=ctx)
        qparams = convert_to_int8(net, params, {**state, 'quant': ctx.new_obs})
        staged = Int8Inference.prepare(qparams, network=net)
        tracing.clear()
        with profile(activities=[ProfilerActivity.CPU]):
            with tracing.span('root'):
                Int8Inference(net).apply(staged, x, plain=plain)
    r = tracing.records()
    spans = sum(1 for s in r['spans'] if s[0] == 'int8.conv3x3')
    direct = list(Int8Inference(net).routes(qparams['act']).values()).count('c3')
    return r['counters'].get('int8.im2col_bytes', 0), spans, direct


@pytest.mark.parametrize('name,plain,direct,spans', [
    ('yolov3', False, 37, 38), ('regnetx-600m-fpn', False, 0, 26),
    ('yolov3', True, 37, 38), ('regnetx-600m-fpn', True, 0, 26)])
def test_the_walk_counts_its_3x3_patches(name, plain, direct, spans):
    """The route table takes the dense 3x3s through ``qconv3x3_s8``
    (YOLOv3's 37 past its stem, with ``plain`` too; none in
    regnetx-600m-fpn, whose 3x3s past its stem are grouped, of group width
    16 and 24, and take ``qgconv3x3_s8``); ``int8.im2col_bytes`` is the
    bytes of the other 3x3s' patches from the shapes (each graph's stem
    alone); one ``int8.conv3x3`` span a non-depthwise 3x3."""
    text = get_cfg(name, num_classes=80 if name == 'yolov3' else 20)
    lays = C.layers(text)
    sides = C.out_sides(lays, SIZE)
    want = sum(sides[l['index']] ** 2 * im2col_depth(l['cin'])
               for l in lays if l['kind'] == 'convolutional' and l['size'] == 3
               and l['groups'] == 1 and l['cin'] % 16)
    assert conv3x3_counters(text, plain=plain) == (want, spans, direct)


# (M, K, N) -> (bm, bn, bk, split, kpr, stages): the plan of every 1x1 and
# im2col GEMM (the stem's) of regnetx-600m-fpn's int8 walk at 512, B=80 (the
# cell rx600-serve-int8-b80), pinned
RX600_B80_PLANS = {
    (20480, 240, 528): (128, 64, 128, 1, 2, 3), (20480, 352, 75): (128, 64, 128, 1, 3, 3),
    (20480, 352, 176): (128, 64, 128, 1, 3, 3), (20480, 352, 352): (128, 64, 128, 1, 3, 3),
    (20480, 528, 352): (128, 64, 128, 1, 5, 3), (20480, 528, 528): (128, 64, 128, 1, 5, 3),
    (81920, 96, 240): (128, 64, 128, 1, 1, 3), (81920, 176, 75): (128, 64, 128, 1, 2, 3),
    (81920, 176, 80): (128, 64, 128, 1, 2, 3), (81920, 176, 176): (128, 64, 128, 1, 2, 3),
    (81920, 240, 240): (128, 64, 128, 1, 2, 3), (81920, 240, 528): (128, 64, 128, 1, 2, 3),
    (81920, 416, 176): (128, 64, 128, 1, 4, 3), (327680, 48, 96): (128, 64, 64, 1, 1, 3),
    (327680, 80, 75): (128, 64, 128, 1, 1, 3), (327680, 80, 80): (128, 64, 128, 1, 1, 3),
    (327680, 96, 96): (128, 64, 128, 1, 1, 3), (327680, 96, 240): (128, 64, 128, 1, 1, 3),
    (327680, 176, 80): (128, 64, 128, 1, 2, 3), (1310720, 32, 48): (128, 64, 32, 1, 1, 3),
    (1310720, 48, 48): (128, 64, 64, 1, 1, 3), (1310720, 48, 96): (128, 64, 64, 1, 1, 3),
    (5242880, 32, 32): (128, 32, 32, 1, 1, 3), (5242880, 32, 48): (128, 64, 32, 1, 1, 3),
}


def test_plans_past_65535_row_tiles_and_at_the_rx600_cell():
    """YOLOv3's stem at B=32 (92,416 row tiles) and a 512 stem at B=128
    (65,536) plan one launch; every GEMM of the rx600 cell keeps its plan."""
    import chip_smoke
    stem = plan_qconv1x1(32 * 608 * 608, 32, 32)
    assert stem.m_blocks == 92_416 and stem.n_blocks == 1 and stem.split == 1
    assert plan_qconv1x1(128 * 256 * 256, 32, 32).m_blocks == 65_536
    net = DetectionNetwork.from_cfg(get_cfg('regnetx-600m-fpn'), quant=True)
    got = {(80 * h * w, k, n): plan_qconv1x1(80 * h * w, k, n).c_args[:6]
           for (kind, h, w, k, n, *_) in chip_smoke.int8_conv_shapes(net, 512)
           if kind in ('pw', 'im2col')}
    assert got == RX600_B80_PLANS


# ------------------------------------------------------------------ card

def card_pw_inputs(gen, m_rows, k, n, dev):
    """Seeded s8 rows (1, m_rows, 1, k), weights, scales, bias, colsum and
    scalars for the 1x1 kernel."""
    x = torch.randint(-128, 128, (1, m_rows, 1, k), generator=gen, dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    w_scale = torch.rand(n, generator=gen) * 0.01 + 0.001
    b = torch.randn(n, generator=gen)
    colsum = w.to(torch.int32).sum(0).to(torch.int32)
    sc = make_scalars(0.02, 37.0, 0.05, 101.0, device='cpu')
    return [t.to(dev) for t in (x, w, w_scale, b, colsum, sc)]


@pytest.mark.cuda
@pytest.mark.parametrize('rows', [32 * 608 * 608, 128 * 256 * 256], ids=['yolov3-b32', 'b128-512'])
def test_card_qconv1x1_past_65535_row_tiles(card, rows):
    """One launch at M over 65,535 row tiles equals the plain version byte
    for byte (the stem's K 32 and N 32), the s8 and the f32 outputs."""
    x, w, w_scale, b, colsum, sc = card_pw_inputs(torch.Generator().manual_seed(rows), rows,
                                                  32, 32, card)
    assert plan_qconv1x1(rows, 32, 32).m_blocks > 65_535
    for requant in (True, False):
        got = qconv1x1_s8(x, w, w_scale, b, colsum, act='leaky', scalars=sc, requant=requant)
        want = qconv1x1_reference(x, w, w_scale, b, colsum, act='leaky', scalars=sc,
                                  requant=requant)
        torch.cuda.synchronize(card)
        assert torch.equal(got, want)


def yolov3_dense_shapes():
    """{(side_in, cin, cout, stride)} of YOLOv3's dense 3x3s at 608."""
    lays = C.layers(FROZEN.read_text())
    return sorted({(608 // (l['stride_total'] // l['stride']), l['cin'], l['cout'], l['stride'])
                   for l in dense_3x3(lays)})


@pytest.mark.cuda
@pytest.mark.parametrize('shape', yolov3_dense_shapes(), ids=lambda s: '-'.join(map(str, s)))
def test_card_every_yolov3_dense_3x3_through_the_route(card, shape):
    """Each dense 3x3 shape at 608, B=2: patches on the card into the 1x1
    kernel against a float64 conv of the same codes with the kernel's
    epilogue, byte for byte."""
    side, cin, cout, stride = shape
    gen = torch.Generator().manual_seed(side * cin + cout)
    xq = torch.randint(-128, 128, (2, side, side, cin), generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (cout, cin, 3, 3), generator=gen, dtype=torch.int8)
    w_scale = torch.rand(cout, generator=gen) * 1e-3 + 1e-4
    b = torch.randn(cout, generator=gen)
    wim = F.pad(wq.permute(2, 3, 1, 0).reshape(9 * cin, cout),
                (0, 0, 0, im2col_depth(cin) - 9 * cin)).contiguous()
    colsum = wim.to(torch.int32).sum(0).to(torch.int32)
    zp = 61.0
    sc = make_scalars(0.03, zp, 0.04, 90.0, device='cpu')
    pad = round(zp) - 128
    xd, wd, sd, bd, cd, scd = (t.to(card) for t in (xq, wim, w_scale, b, colsum, sc))
    got = qconv1x1_s8(_stem_im2col(xd, stride, pad), wd, sd, bd, cd, act='relu', scalars=scd,
                      requant=True)
    # float64 sums of these integers are exact in any order (under 2^53)
    xp = F.pad(xd.double().permute(0, 3, 1, 2), (1,) * 4, value=float(pad))
    acc = F.conv2d(xp, wq.to(card).double(), None, stride).permute(0, 2, 3, 1).float()
    want = _epilogue(acc, scd.reshape(-1), sd, bd, cd.float(), 'relu', True)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize('precision', ['int8', 'bf16'])
def test_card_whole_walk_at_608_within_the_cells_limits(card, precision):
    """The serving cell's path (calibration, the predict pipeline, recover
    and NMS) at 608, B=2, in int8 kernel mode and in bf16 (cuDNN, leaky),
    against the plain reference: the cell's limits hold."""
    spec = harness.load_spec()
    cell = harness.load_cell(spec, CELL)
    cell['traffic'].update(batch=2, pool=2, check_requests=2, calib_batch=2, warmup=1,
                           precision=precision)
    seed = 3_141_592_653
    from benchmark.trace import Tracer
    drv = harness.driver_of(cell, seed, card, Tracer(False))
    drv.setup()
    drv.window(0.5)
    drv.free()
    numbers = drv.check(harness.seed_streams(seed, card)('sample'))
    ok, table = compare.judge(numbers, cell['limits'])
    assert ok, table
    assert np.isfinite(list(numbers.values())).all()
