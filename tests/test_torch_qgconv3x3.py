"""The grouped int8 3x3 conv (``ops/qconv.py::qgconv3x3_s8``, ``csrc/qconv.cu``):
each group's product read straight from the input window, in place of the
densified im2col route (block-diagonal weights, patches into
``qconv1x1_s8``).

On the CPU: the plain version equals the densified route's plain versions
byte for byte (group widths 8, 16 and 24, 2 to 22 groups, stride 1 and 2,
s8 and f32 out, several zero points); ``prepare`` stages the compact
``wg`` view for a ``'g3'`` conv and densifies none; a grouped width the
kernel does not take keeps ``'im2col'``; a small graph's walk follows the
route table whichever kernels run and equals the walk through the
densified route node by node; the registered operator's fake function and
an exported kernel program. On the card (marker ``cuda``, skipped
elsewhere; run there with ``python -m pytest -m cuda
tests/test_torch_qgconv3x3.py``): the kernel equals the route on the card
byte for byte at every grouped 3x3 shape of regnetx-600m-fpn at 512 (B=1
and the serving cell's B=80), at regnety-400m-fpn's group-width-8 shapes
and at edge shapes, and a regnetx-600m-fpn walk with the kernel equals the
walk with its plain version node by node.
"""

import collections

import pytest
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.profiler import ProfilerActivity, profile

from pqdet_tpu_torch.compress.qat import QuantCtx, prepare_qat_state
from pqdet_tpu_torch.compress.quantized import (Int8Inference, _stem_im2col, conv_route,
                                                convert_to_int8, im2col_depth)
from pqdet_tpu_torch.exporters.export import export_stablehlo_quant, load_stablehlo
from pqdet_tpu_torch.model import layers as L
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.ops import library
from pqdet_tpu_torch.ops.qconv import (G3_GROUP_WIDTHS, make_scalars, plan_qgconv3x3,
                                       qconv1x1_reference, qconv1x1_s8, qgconv3x3_reference,
                                       qgconv3x3_s8, qgconv3x3_smem_bytes)
from pqdet_tpu_torch.utils import tracing
from pqdet_tpu_torch.zoo import get_cfg


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: qgconv3x3_s8 runs only there')
    return torch.device('cuda', 0)


# calibrated and walk_records as tests/test_torch_qconv3x3.py has them: this
# file imports nothing from ``tests.``, whose name another package may take
# in the card's Python
def calibrated(cfg_text, size, batch=2, dev='cpu'):
    """(quant net, int8 qparams, normalized input) from the net's init and
    one observer pass."""
    net = DetectionNetwork.from_cfg(cfg_text, quant=True)
    params, state = net.init(torch.Generator().manual_seed(0), device=dev)
    params, state = prepare_qat_state(net, params, state)
    x = torch.rand((batch, size, size, 3), generator=torch.Generator().manual_seed(1)).to(dev)
    with torch.inference_mode():
        ctx = QuantCtx(state['quant'], observing=True)
        net(params, state, x, quant_ctx=ctx)
        qparams = convert_to_int8(net, params, {**state, 'quant': ctx.new_obs})
    return net, qparams, x


def walk_records(net, staged, x, **kw):
    """(preds, node outputs, counters, int8.conv3x3 spans) of one kernel-mode
    forward under the profiler."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]), torch.inference_mode():
        with tracing.span('root'):
            preds, inter = Int8Inference(net).apply(staged, x, intermediates=True, **kw)
    r = tracing.records()
    return preds, inter, r['counters'], sum(1 for s in r['spans'] if s[0] == 'int8.conv3x3')


def grouped_inputs(gen, n, h, w, cin, gw):
    """Seeded s8 input, compact grouped weights (Cin, gw, 3, 3), their
    (Cin, 9 * gw) view (the kernel's), the densified im2col view (the
    route's), scales, bias, colsum."""
    x = torch.randint(-128, 128, (n, h, w, cin), generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (cin, gw, 3, 3), generator=gen, dtype=torch.int8)
    wg = wq.permute(0, 2, 3, 1).reshape(cin, 9 * gw).contiguous()
    wim = densified_view(wg)
    w_scale = torch.rand(cin, generator=gen) * 0.01 + 0.001
    b = torch.randn(cin, generator=gen)
    colsum = wg.to(torch.int32).sum(1).to(torch.int32)
    return x, wg, wim, w_scale, b, colsum


def densified_view(wg):
    """The im2col route's weights of compact ``wg`` (Cout, 9 * gw):
    block-diagonal (Cout, Cout, 3, 3), then (im2col_depth(Cout), Cout) in
    (kh, kw, cin) order, as ``Int8Inference.prepare`` stages a densified
    conv."""
    cout, gw = wg.shape[0], wg.shape[1] // 9
    dense = L.densify_grouped_weight(wg.reshape(cout, 3, 3, gw).permute(0, 3, 1, 2),
                                     cout // gw)
    wim = dense.permute(2, 3, 1, 0).reshape(9 * cout, cout)
    return F.pad(wim, (0, 0, 0, im2col_depth(cout) - 9 * cout)).contiguous()


def route(x, wg, w_scale, b, colsum, *, act, stride, scalars, requant, pw=qconv1x1_reference):
    """The densified im2col route of the walk, with ``qgconv3x3_s8``'s
    signature: patches padded with round(x_zp) - 128 into the 1x1 conv on
    block-diagonal weights (their colsum is the compact weights')."""
    pad = round(float(scalars.reshape(-1)[1])) - 128
    return pw(_stem_im2col(x, stride, pad), densified_view(wg), w_scale, b, colsum, act=act,
              scalars=scalars, requant=requant)


@pytest.mark.parametrize('requant', [True, False], ids=['s8', 'f32'])
@pytest.mark.parametrize('zp', [0.0, 255.0, 101.0])
@pytest.mark.parametrize('n,h,w,gw,groups,stride', [
    (2, 6, 10, 8, 2, 1), (1, 8, 6, 8, 13, 2), (2, 5, 7, 16, 5, 1), (1, 4, 4, 16, 22, 2),
    (2, 6, 6, 24, 2, 2), (1, 3, 5, 24, 10, 1), (1, 2, 2, 24, 22, 2)])
def test_plain_version_equals_the_densified_route(n, h, w, gw, groups, stride, zp, requant):
    """Byte for byte, every output a border pixel or near one at these
    sides; the wrapper runs the plain version for a CPU tensor."""
    cin = gw * groups
    gen = torch.Generator().manual_seed(h * w * cin + int(zp))
    x, wg, wim, w_scale, b, colsum = grouped_inputs(gen, n, h, w, cin, gw)
    assert torch.equal(wim.to(torch.int32).sum(0).to(torch.int32), colsum)
    sc = make_scalars(0.02, zp, 0.05 if requant else None, 117.0 if requant else None,
                      device='cpu')
    kw = dict(act='leaky', stride=stride, scalars=sc, requant=requant)
    want = route(x, wg, w_scale, b, colsum, **kw)
    got = qgconv3x3_reference(x, wg, w_scale, b, colsum, **kw)
    assert got.shape == (n, h // stride, w // stride, cin) and got.is_contiguous()
    assert got.dtype == (torch.int8 if requant else torch.float32)
    assert torch.equal(got, want)
    assert torch.equal(qgconv3x3_s8(x, wg, w_scale, b, colsum, **kw), want)


def test_stride_2_needs_even_sides():
    gen = torch.Generator().manual_seed(0)
    x, wg, _, w_scale, b, colsum = grouped_inputs(gen, 1, 5, 6, 16, 8)
    sc = make_scalars(0.02, 3.0, device='cpu')
    with pytest.raises(ValueError, match='even'):
        qgconv3x3_s8(x, wg, w_scale, b, colsum, act='relu', stride=2, scalars=sc,
                     requant=False)


def attrs(cin, cout, groups, stride=1):
    return dict(size=3, stride=stride, padding=1, pad=1, groups=groups, filters=cout)


@pytest.mark.parametrize('gw', G3_GROUP_WIDTHS)
def test_group_widths_8_16_24_take_the_kernel(gw):
    for groups, stride in ((2, 1), (5, 2), (22, 1)):
        assert conv_route(attrs(gw * groups, gw * groups, groups, stride), gw * groups) == 'g3'


@pytest.mark.parametrize('cin,cout,groups', [
    (48, 48, 12), (48, 48, 4), (60, 60, 5), (64, 64, 2), (96, 96, 3), (40, 80, 5)],
    ids=['gw4', 'gw12', 'gw12-odd', 'gw32', 'gw32-3', 'cout-not-cin'])
def test_other_grouped_widths_keep_im2col(cin, cout, groups):
    """A group width not a multiple of 8 (4, 12), past the widest the kernel
    takes (32), or a Cout other than Cin: the densified route."""
    assert conv_route(attrs(cin, cout, groups), cin) == 'im2col'


def test_plan_at_the_cell_and_the_layout_bytes():
    """The plans of the rx600-serve-int8-b80 cell's grouped shapes (B=80),
    pinned as the sweep chose them (PERF.md); the layout's bytes: a pixel's
    pitch is 16 mod 32 bytes (48 channels keep 48, 96 take 112), windows of
    10 x 34 and 17 x 65 pixels rounded up to 128 bytes; a group width the
    kernel lacks is refused (the RegNets' plans at B=1, 4 and 16 are in
    tests/test_torch_kernel_plan.py)."""
    want = {(16, 352, 16, 1): (16, 16, 4, 2), (16, 528, 24, 1): (16, 16, 4, 2),
            (32, 176, 16, 1): (8, 32, 4, 2), (32, 240, 24, 1): (8, 32, 4, 2),
            (32, 528, 24, 2): (8, 16, 2, 1), (64, 80, 16, 1): (8, 32, 3, 2),
            (64, 96, 24, 1): (8, 32, 4, 2), (64, 240, 24, 2): (8, 32, 2, 1),
            (128, 96, 24, 2): (8, 32, 2, 1), (256, 48, 24, 2): (8, 32, 2, 1)}
    assert {s: plan_qgconv3x3(80, s[0], s[0], *s[1:]).c_args[:4]
            for s in grouped_shapes('regnetx-600m-fpn')} == want
    assert qgconv3x3_smem_bytes(8, 32, 2, 24, 1, 1) == 16384 + 256 * 48
    assert qgconv3x3_smem_bytes(8, 32, 4, 24, 2, 2) == 2 * 123776 + 256 * 96
    with pytest.raises(ValueError, match='group width'):
        plan_qgconv3x3(1, 8, 8, 40, 10, 1)


# a Cin-3 stem, then grouped 3x3s of group width 8 (stride 2, 5 groups), 16
# (2 groups) and 24 (stride 2, 2 groups), a grouped 3x3 of width 4 (kept on
# the densified route) and a dense 3x3 of Cin 48
GROUPED_CFG = """[net]
channels=3

[convolutional]
filters=40
size=3
stride=1
pad=1
batch_normalize=1
activation=relu

[convolutional]
filters=40
size=3
stride=2
pad=1
groups=5
batch_normalize=1
activation=relu

[convolutional]
filters=32
size=1
stride=1
pad=1
batch_normalize=1
activation=relu

[convolutional]
filters=32
size=3
stride=1
pad=1
groups=2
batch_normalize=1
activation=relu

[convolutional]
filters=48
size=1
stride=1
pad=1
batch_normalize=1
activation=relu

[convolutional]
filters=48
size=3
stride=2
pad=1
groups=2
batch_normalize=1
activation=relu

[convolutional]
filters=48
size=3
stride=1
pad=1
groups=12
batch_normalize=1
activation=relu

[convolutional]
filters=48
size=3
stride=1
pad=1
batch_normalize=1
activation=relu

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
GROUPED_SIZE = 32
G3 = ('1', '3', '5')                   # the convs that take qgconv3x3_s8


@pytest.fixture(scope='module')
def grouped_model():
    return calibrated(GROUPED_CFG, GROUPED_SIZE)


def test_prepare_stages_the_compact_view_for_g3(grouped_model):
    """``wg`` (Cout, 9 * gw) of the compact weights in (kh, kw, cin) order
    and its ``colsum`` for the three 'g3' convs, and no ``wim``: nothing of
    theirs is densified; the width-4 grouped 3x3 keeps its densified
    ``wim``."""
    net, qparams, _ = grouped_model
    layers = Int8Inference.prepare(qparams, network=net)['layers']
    assert sorted(k for k, p in layers.items() if 'wg' in p) == list(G3)
    assert sorted(k for k, p in layers.items() if 'wim' in p) == ['0', '6']
    for k in G3:
        p, wq = layers[k], qparams['layers'][k]['wq']
        cout, gw = wq.shape[:2]
        assert 'wim' not in p and 'w2d' not in p
        assert p['wg'].shape == (cout, 9 * gw) and p['wg'].is_contiguous()
        assert torch.equal(p['wg'].reshape(cout, 3, 3, gw).permute(0, 3, 1, 2), wq)
        assert torch.equal(p['colsum'], wq.to(torch.int32).sum((1, 2, 3)).to(torch.int32))
    assert layers['6']['wim'].shape == (im2col_depth(48), 48)


@pytest.mark.parametrize('how', ['wrappers', 'plain', 'ops'])
def test_walk_follows_the_route_and_equals_the_densified_walk(grouped_model, how):
    """The route table takes the three grouped 3x3s of width 8, 16 and 24
    through ``qgconv3x3_s8`` (one ``int8.conv3x3`` span each, no patches)
    and the walk follows it whichever kernels run; every node equals the
    walk whose grouped entry is the densified route, byte for byte."""
    net, qparams, x = grouped_model
    staged = Int8Inference.prepare(qparams, network=net)
    routes = Int8Inference(net).routes(qparams['act'])
    assert sorted(k for k, r in routes.items() if r == 'g3') == list(G3)
    assert sorted(k for k, r in routes.items() if r == 'im2col') == ['0', '6']
    kw = {'wrappers': {}, 'plain': {'plain': True}, 'ops': {'kernels': library.OPS}}[how]
    preds, inter, counters, spans = walk_records(net, staged, x, **kw)
    n, s = x.shape[0], GROUPED_SIZE
    assert spans == 6
    assert counters['int8.im2col_bytes'] == n * s * s * im2col_depth(3) \
        + n * (s // 4) ** 2 * im2col_depth(48)
    with torch.inference_mode():
        ref_preds, ref_inter = Int8Inference(net).apply(
            staged, x, intermediates=True, kernels=library.PLAIN._replace(qgconv3x3=route))
    assert sorted(inter) == sorted(ref_inter)
    assert [k for k in inter if not torch.equal(inter[k], ref_inter[k])] == []
    assert torch.equal(preds, ref_preds)


def test_operator_fake_gives_shape_and_dtype():
    with FakeTensorMode():
        x = torch.empty((2, 8, 6, 48), dtype=torch.int8)
        w = torch.empty((48, 9 * 24), dtype=torch.int8)
        v = torch.empty((48,), dtype=torch.float32)
        cs = torch.empty((48,), dtype=torch.int32)
        sc = torch.empty((1, 4), dtype=torch.float32)
        s8 = torch.ops.pqdet.qgconv3x3_s8(x, w, v, v, cs, sc, 'relu', 2, True)
        f32 = torch.ops.pqdet.qgconv3x3_s8(x, w, v, v, cs, sc, 'linear', 1, False)
    assert tuple(s8.shape) == (2, 4, 3, 48) and s8.dtype == torch.int8
    assert tuple(f32.shape) == (2, 8, 6, 48) and f32.dtype == torch.float32
    assert 'qgconv3x3_s8' in library.OP_NAMES
    assert library.OPS.qgconv3x3 is library.qgconv3x3_s8
    assert library.WRAPPERS.qgconv3x3 is qgconv3x3_s8
    assert library.PLAIN.qgconv3x3 is qgconv3x3_reference


def test_exported_kernel_program_calls_the_operator(grouped_model):
    """A kernel-mode program of the small graph holds three
    ``qgconv3x3_s8`` calls, and gives the eager walk's preds."""
    net, qparams, x = grouped_model
    blob = export_stablehlo_quant(net, qparams, (GROUPED_SIZE, GROUPED_SIZE), x.shape[0],
                                  'kernel', device='cpu')
    fn = load_stablehlo(blob, device='cpu')
    ops = collections.Counter(library.graph_ops(fn))
    assert ops['pqdet.qgconv3x3_s8.default'] == 3 and ops['pqdet.qconv3x3_s8.default'] == 1
    staged = Int8Inference.prepare(qparams, network=net)
    with torch.inference_mode():
        assert torch.equal(fn(x), Int8Inference(net).apply(staged, x))


def grouped_shapes(name, size=512):
    """Sorted (side_in, Cin, gw, stride) of the 'g3' convs of zoo graph
    ``name`` at ``size``."""
    net = DetectionNetwork.from_cfg(get_cfg(name), quant=True)
    return sorted({(size * n.attrs['stride'] // n.stride, n.in_channels,
                    n.in_channels // n.attrs['groups'], n.attrs['stride'])
                   for n in net.graph.nodes
                   if n.kind == 'convolutional' and conv_route(n.attrs, n.in_channels) == 'g3'})


def test_the_regnets_grouped_shapes():
    """regnetx-600m-fpn's 25 grouped 3x3s in 10 shapes (group width 24 in the
    backbone, 16 in the head), regnety-400m-fpn's group-width-8 ones in 7."""
    x = grouped_shapes('regnetx-600m-fpn')
    assert len(x) == 10 and {gw for _, _, gw, _ in x} == {16, 24}
    y8 = [s for s in grouped_shapes('regnety-400m-fpn') if s[2] == 8]
    assert len(y8) == 7 and {c for _, c, _, _ in y8} == {48, 104, 208, 440}


# ------------------------------------------------------------------ card

def card_equal_to_route(dev, n, h, w, cin, gw, stride, seed, act='relu'):
    gen = torch.Generator().manual_seed(seed)
    x, wg, _, w_scale, b, colsum = (t.to(dev) for t in grouped_inputs(gen, n, h, w, cin, gw))
    bad = []
    for requant, zp in ((True, 37.0), (False, 0.0), (True, 255.0)):
        sc = make_scalars(0.02, zp, 0.05 if requant else None, 101.0 if requant else None,
                          device=dev)
        kw = dict(act=act, stride=stride, scalars=sc, requant=requant)
        got = qgconv3x3_s8(x, wg, w_scale, b, colsum, **kw)
        want = route(x, wg, w_scale, b, colsum, pw=qconv1x1_s8, **kw)
        torch.cuda.synchronize(dev)
        if not torch.equal(got, want):
            bad.append((requant, zp))
    return bad


@pytest.mark.cuda
@pytest.mark.parametrize('batch', [1, 80])
@pytest.mark.parametrize('shape', grouped_shapes('regnetx-600m-fpn'),
                         ids=lambda s: '-'.join(map(str, s)))
def test_card_every_regnetx_grouped_3x3_equals_the_route(card, shape, batch):
    """At 512, B=1 and the serving cell's B=80: the kernel against patches on
    the card into ``qconv1x1_s8`` on the densified weights, byte for byte,
    s8 and f32 out, zero points 37, 0 and 255."""
    side, cin, gw, stride = shape
    assert card_equal_to_route(card, batch, side, side, cin, gw, stride, side * cin) == []


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [s for s in grouped_shapes('regnety-400m-fpn') if s[2] == 8],
                         ids=lambda s: '-'.join(map(str, s)))
def test_card_regnety_group_width_8_equals_the_route(card, shape):
    """regnety-400m-fpn's gw-8 shapes at 512, B=2 (Cin 104 and 440: 8-byte
    copies), against the route byte for byte."""
    side, cin, gw, stride = shape
    assert card_equal_to_route(card, 2, side, side, cin, gw, stride, side + cin) == []


@pytest.mark.cuda
@pytest.mark.parametrize('n,h,w,cin,gw,stride,act', [
    (3, 20, 36, 72, 24, 1, 'leaky'), (4, 10, 14, 40, 8, 2, 'linear'),
    (2, 7, 9, 352, 16, 1, 'relu6'), (4, 2, 2, 48, 24, 2, 'relu'),
    (1, 66, 130, 176, 16, 2, 'relu'), (2, 17, 33, 24, 24, 1, 'relu')])
def test_card_edge_shapes_equal_the_plain_version(card, n, h, w, cin, gw, stride, act):
    """Odd sides and outputs not a multiple of the tile, Cin 72 (three
    groups of 24: a last slice of one group, 8-byte copies), Cin 40 of width
    8, 22 groups of 16, one output pixel, one group: the kernel against its
    plain version, and against the route."""
    gen = torch.Generator().manual_seed(h * w + cin)
    x, wg, _, w_scale, b, colsum = (t.to(card) for t in grouped_inputs(gen, n, h, w, cin, gw))
    for requant in (True, False):
        sc = make_scalars(0.02, 90.0, 0.05 if requant else None, 60.0 if requant else None,
                          device=card)
        kw = dict(act=act, stride=stride, scalars=sc, requant=requant)
        got = qgconv3x3_s8(x, wg, w_scale, b, colsum, **kw)
        want = qgconv3x3_reference(x, wg, w_scale, b, colsum, **kw)
        torch.cuda.synchronize(card)
        assert torch.equal(got, want)
    assert card_equal_to_route(card, n, h, w, cin, gw, stride, 3, act) == []


@pytest.mark.cuda
def test_card_regnetx_walk_with_the_kernel_equals_the_walk_with_its_plain_version(card):
    """regnetx-600m-fpn in kernel mode at 320 px, B=2: every node's output and
    the preds with ``qgconv3x3_s8`` equal those with its plain version on
    the same routes (the other kernels the same in both), byte for byte; 25
    launches."""
    net, qparams, x = calibrated(get_cfg('regnetx-600m-fpn'), 320, dev=card)
    inf = Int8Inference(net)
    staged = Int8Inference.prepare(qparams, network=net)
    with torch.inference_mode():
        before = qgconv3x3_s8.launches
        kern, ik = inf.apply(staged, x, intermediates=True)
        launches = qgconv3x3_s8.launches - before
        plain, ip = inf.apply(staged, x, intermediates=True,
                              kernels=library.WRAPPERS._replace(qgconv3x3=qgconv3x3_reference))
    torch.cuda.synchronize()
    assert launches == 25
    assert sorted(ik) == sorted(ip)
    assert [k for k in ik if not torch.equal(ik[k], ip[k])] == []
    assert torch.equal(kern, plain)
