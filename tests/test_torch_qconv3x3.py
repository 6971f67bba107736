"""The dense int8 3x3 conv (``ops/qconv.py::qconv3x3_s8``, ``csrc/qconv.cu``):
an implicit GEMM that reads its input window straight from device memory,
in place of the im2col route (patches into ``qconv1x1_s8``).

On the CPU: the plain version equals the route's plain versions byte for
byte (borders, stride 2, zero points 0 and 255, s8 and f32 out); the
walk's route table on a small graph (dense Cin 32 and 48 at stride 1 and
2 take the kernel; a grouped 3x3 of width 8 takes ``qgconv3x3_s8``; a
Cin-3 stem and Cin 40 keep the patches; ``plain`` and the registered
operators take the same routes),
with equal outputs whichever kernels run; the registered operator's fake
function and an exported kernel program. On the card (marker ``cuda``,
skipped elsewhere; run there with ``python -m pytest -m cuda
tests/test_torch_qconv3x3.py``): the kernel equals the route on the card
byte for byte at every YOLOv3 dense 3x3 shape at 608 (B=1 and 2, one at
B=32) and at edge shapes, and a YOLOv3 walk with the kernel equals the
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
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.ops import library
from pqdet_tpu_torch.ops.qconv import (make_scalars, qconv1x1_reference, qconv1x1_s8,
                                       qconv3x3_reference, qconv3x3_s8)
from pqdet_tpu_torch.utils import tracing
from pqdet_tpu_torch.zoo import get_cfg


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: qconv3x3_s8 runs only there')
    return torch.device('cuda', 0)


def conv_inputs(gen, n, h, w, cin, cout):
    """Seeded s8 input, (Cout, Cin, 3, 3) int8 weights, their K-major view
    (the kernel's) and im2col view (the route's), scales, bias, colsum."""
    x = torch.randint(-128, 128, (n, h, w, cin), generator=gen, dtype=torch.int8)
    wq = torch.randint(-127, 128, (cout, cin, 3, 3), generator=gen, dtype=torch.int8)
    w3 = wq.permute(0, 2, 3, 1).reshape(cout, 9 * cin).contiguous()
    wim = F.pad(w3.t(), (0, 0, 0, im2col_depth(cin) - 9 * cin)).contiguous()
    w_scale = torch.rand(cout, generator=gen) * 0.01 + 0.001
    b = torch.randn(cout, generator=gen)
    colsum = wim.to(torch.int32).sum(0).to(torch.int32)
    return x, w3, wim, w_scale, b, colsum


def route(x, wim, w_scale, b, colsum, stride, sc, requant, act='leaky', pw=qconv1x1_reference):
    """The im2col route of the walk: patches padded with round(x_zp) - 128
    into the 1x1 conv."""
    pad = round(float(sc[0, 1])) - 128
    return pw(_stem_im2col(x, stride, pad), wim, w_scale, b, colsum, act=act, scalars=sc,
              requant=requant)


@pytest.mark.parametrize('requant', [True, False], ids=['s8', 'f32'])
@pytest.mark.parametrize('zp', [0.0, 255.0, 101.0])
@pytest.mark.parametrize('n,h,w,cin,cout,stride', [
    (2, 6, 10, 32, 24, 1), (2, 8, 6, 48, 64, 2), (1, 2, 2, 16, 8, 2), (1, 5, 3, 16, 75, 1)])
def test_plain_version_equals_the_im2col_route(n, h, w, cin, cout, stride, zp, requant):
    """Byte for byte, every output a border pixel or near one at these
    sides; the wrapper runs the plain version for a CPU tensor."""
    gen = torch.Generator().manual_seed(h * w * cin + cout + int(zp))
    x, w3, wim, w_scale, b, colsum = conv_inputs(gen, n, h, w, cin, cout)
    sc = make_scalars(0.02, zp, 0.05 if requant else None, 117.0 if requant else None,
                      device='cpu')
    want = route(x, wim, w_scale, b, colsum, stride, sc, requant)
    got = qconv3x3_reference(x, w3, w_scale, b, colsum, act='leaky', stride=stride, scalars=sc,
                             requant=requant)
    assert got.shape == (n, h // stride, w // stride, cout) and got.is_contiguous()
    assert got.dtype == (torch.int8 if requant else torch.float32)
    assert torch.equal(got, want)
    assert torch.equal(qconv3x3_s8(x, w3, w_scale, b, colsum, act='leaky', stride=stride,
                                   scalars=sc, requant=requant), want)


def test_stride_2_needs_even_sides():
    gen = torch.Generator().manual_seed(0)
    x, w3, _, w_scale, b, colsum = conv_inputs(gen, 1, 5, 6, 16, 8)
    sc = make_scalars(0.02, 3.0, device='cpu')
    with pytest.raises(ValueError, match='even'):
        qconv3x3_s8(x, w3, w_scale, b, colsum, act='relu', stride=2, scalars=sc, requant=False)


# dense 3x3s at Cin 32 and 48, stride 1 and 2 (the kernel's), then a grouped
# 3x3 (group width 8: qgconv3x3_s8's) and Cin 40 (not a multiple of 16),
# after a Cin-3 stem: the stem and Cin 40 keep the im2col route
ROUTING_CFG = """[net]
channels=3

[convolutional]
filters=32
size=3
stride=1
pad=1
batch_normalize=1
activation=leaky

[convolutional]
filters=32
size=3
stride=1
pad=1
batch_normalize=1
activation=leaky

[convolutional]
filters=48
size=3
stride=2
pad=1
batch_normalize=1
activation=leaky

[convolutional]
filters=48
size=3
stride=1
pad=1
batch_normalize=1
activation=leaky

[convolutional]
filters=40
size=3
stride=2
pad=1
batch_normalize=1
activation=leaky

[convolutional]
filters=40
size=3
stride=1
pad=1
groups=5
batch_normalize=1
activation=leaky

[convolutional]
filters=32
size=3
stride=1
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
ROUTING_SIZE = 32
DIRECT = ('1', '2', '3', '4')          # the convs that take qconv3x3_s8


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


@pytest.fixture(scope='module')
def routing_model():
    return calibrated(ROUTING_CFG, ROUTING_SIZE)


def walk_records(net, staged, x, **kw):
    """(preds, node outputs, counters, int8.conv3x3 spans) of one kernel-mode
    forward under the profiler."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]), torch.inference_mode():
        with tracing.span('root'):
            preds, inter = Int8Inference(net).apply(staged, x, intermediates=True, **kw)
    r = tracing.records()
    return preds, inter, r['counters'], sum(1 for s in r['spans'] if s[0] == 'int8.conv3x3')


def test_prepare_stages_the_k_major_view_for_dense_cin_multiples_of_16(routing_model):
    """``w3`` (Cout, 9 * Cin) in (kh, kw, cin) order and its ``colsum`` for
    the dense 3x3s of Cin 32, 48 and 48; ``wim`` only for the stem and Cin
    40, the 3x3s whose route is im2col (the grouped conv stages ``wg``)."""
    net, qparams, _ = routing_model
    layers = Int8Inference.prepare(qparams, network=net)['layers']
    assert sorted(k for k, p in layers.items() if 'w3' in p) == list(DIRECT)
    assert sorted(k for k, p in layers.items() if 'wim' in p) == ['0', '6']
    assert sorted(k for k, p in layers.items() if 'wg' in p) == ['5']
    for k in DIRECT:
        p, wq = layers[k], qparams['layers'][k]['wq']
        cout, cin = wq.shape[:2]
        assert p['w3'].shape == (cout, 9 * cin) and p['w3'].is_contiguous()
        assert torch.equal(p['w3'].reshape(cout, 3, 3, cin).permute(0, 3, 1, 2), wq)
        assert torch.equal(p['colsum'], wq.to(torch.int32).sum((1, 2, 3)).to(torch.int32))


@pytest.mark.parametrize('how,direct', [('wrappers', 4), ('plain', 4), ('ops', 4)])
def test_routing_and_counters_on_a_small_graph(routing_model, how, direct):
    """The route table takes the four dense 3x3s of Cin 32 and 48 through
    ``qconv3x3_s8``, the grouped 3x3 through ``qgconv3x3_s8`` and the other
    two 3x3s through patches, and the walk follows it whichever kernels run
    (the wrappers, their plain versions, the registered operators):
    ``int8.im2col_bytes`` counts the two 3x3s' patches alone, one
    ``int8.conv3x3`` span a 3x3; every node equals the plain walk's byte for
    byte."""
    net, qparams, x = routing_model
    staged = Int8Inference.prepare(qparams, network=net)
    kw = {'wrappers': {}, 'plain': {'plain': True}, 'ops': {'kernels': library.OPS}}[how]
    routes = Int8Inference(net).routes(qparams['act'])
    c3 = sorted(k for k, r in routes.items() if r == 'c3')
    assert len(c3) == direct and c3 == list(DIRECT)
    assert sorted(k for k, r in routes.items() if r == 'im2col') == ['0', '6']
    assert [k for k, r in routes.items() if r == 'g3'] == ['5']
    preds, inter, counters, spans = walk_records(net, staged, x, **kw)
    n = x.shape[0]
    s = ROUTING_SIZE
    patched = {'0': (s, 3), '6': (s // 4, 40)}
    assert spans == 7
    assert counters['int8.im2col_bytes'] == sum(n * side ** 2 * im2col_depth(cin)
                                                for side, cin in patched.values())
    ref_preds, ref_inter = Int8Inference(net).apply(staged, x, intermediates=True, plain=True)
    assert sorted(inter) == sorted(ref_inter)
    assert [k for k in inter if not torch.equal(inter[k], ref_inter[k])] == []
    assert torch.equal(preds, ref_preds)


def test_operator_fake_gives_shape_and_dtype():
    with FakeTensorMode():
        x = torch.empty((2, 8, 6, 32), dtype=torch.int8)
        w = torch.empty((48, 9 * 32), dtype=torch.int8)
        v = torch.empty((48,), dtype=torch.float32)
        cs = torch.empty((48,), dtype=torch.int32)
        sc = torch.empty((1, 4), dtype=torch.float32)
        s8 = torch.ops.pqdet.qconv3x3_s8(x, w, v, v, cs, sc, 'leaky', 2, True)
        f32 = torch.ops.pqdet.qconv3x3_s8(x, w, v, v, cs, sc, 'linear', 1, False)
    assert tuple(s8.shape) == (2, 4, 3, 48) and s8.dtype == torch.int8
    assert tuple(f32.shape) == (2, 8, 6, 48) and f32.dtype == torch.float32
    assert 'qconv3x3_s8' in library.OP_NAMES and library.OPS.qconv3x3 is library.qconv3x3_s8
    assert library.WRAPPERS.qconv3x3 is qconv3x3_s8
    assert library.PLAIN.qconv3x3 is qconv3x3_reference


def test_exported_kernel_program_calls_the_operator(routing_model):
    """A kernel-mode program of the small graph holds four ``qconv3x3_s8``
    calls, one ``qgconv3x3_s8`` call and two 1x1 calls on patches besides
    the head's, and gives the eager walk's preds."""
    net, qparams, x = routing_model
    blob = export_stablehlo_quant(net, qparams, (ROUTING_SIZE, ROUTING_SIZE), x.shape[0],
                                  'kernel', device='cpu')
    fn = load_stablehlo(blob, device='cpu')
    ops = collections.Counter(library.graph_ops(fn))
    assert ops['pqdet.qconv3x3_s8.default'] == 4 and ops['pqdet.qconv1x1_s8.default'] == 3
    assert ops['pqdet.qgconv3x3_s8.default'] == 1
    staged = Int8Inference.prepare(qparams, network=net)
    with torch.inference_mode():
        assert torch.equal(fn(x), Int8Inference(net).apply(staged, x))


def test_every_zoo_3x3_the_kernel_takes_is_yolov3s():
    """Of the zoo's graphs only YOLOv3 has dense 3x3s whose Cin is a
    multiple of C3_CIN_STEP: its 37 past the stem, in 10 shapes at 608."""
    from pqdet_tpu_torch.zoo import MODEL_ZOO
    takes = {}
    for name in sorted(MODEL_ZOO):
        net = DetectionNetwork.from_cfg(get_cfg(name), quant=True)
        takes[name] = [n.in_channels for n in net.graph.nodes if n.kind == 'convolutional'
                       and conv_route(n.attrs, n.in_channels) == 'c3']
    assert {k: len(v) for k, v in takes.items() if v} == {'yolov3': 37}
    assert len(yolov3_shapes()) == 10


@pytest.mark.parametrize('name,want', [
    ('mobilenetv2-fpn', {'pw': 57, 'dw': 26, 'im2col': 1, 'sandwich': 15}),
    ('regnetx-600m-fpn', {'pw': 62, 'g3': 25, 'im2col': 1, 'sandwich': 37}),
    ('regnety-400m-fpn', {'pw': 94, 'g3': 25, 'im2col': 1, 'sandwich': 37, None: 32}),
    ('yolov3', {'pw': 37, 'c3': 37, 'im2col': 1, 'sandwich': 28})])
def test_route_table_of_the_zoo_graphs(name, want):
    """Each zoo graph's route counts, pinned: YOLOv3's 37 dense 3x3s past
    its stem take ``'c3'`` and its stem ``'im2col'``; the RegNets' 25
    grouped 3x3s (group width 24 and 16 in regnetx-600m-fpn, 8 and 16 in
    regnety-400m-fpn) ``'g3'`` and their stems ``'im2col'``; every conv and
    sandwich node takes a route (regnety-400m-fpn's 32 squeeze-excite
    scales keep their chain: None). A walk at 64 px through the plain
    versions calls each kernel entry once a route (the 1x1 entry for
    ``'pw'`` and ``'im2col'``) and the decode once."""
    net, qparams, x = calibrated(get_cfg(name), 64, batch=1)
    inf = Int8Inference(net)
    routes = collections.Counter(inf.routes(qparams['act']).values())
    assert routes == want
    calls = collections.Counter()

    def spy(entry, fn):
        def call(*args, **kw):
            calls[entry] += 1
            return fn(*args, **kw)
        return call
    table = library.Kernels(*(spy(e, fn) for e, fn in zip(library.Kernels._fields,
                                                           library.PLAIN)))
    with torch.inference_mode():
        inf.apply(Int8Inference.prepare(qparams, network=net), x, kernels=table)
    assert calls == collections.Counter(
        qconv1x1=routes['pw'] + routes['im2col'], qdwconv3x3=routes['dw'],
        qconv3x3=routes['c3'], qgconv3x3=routes['g3'], sandwich=routes['sandwich'], decode=1)


def yolov3_shapes():
    """Sorted (side_in, cin, cout, stride) of YOLOv3's dense 3x3s that
    qconv3x3_s8 takes at 608."""
    net = DetectionNetwork.from_cfg(get_cfg('yolov3', num_classes=80), quant=True)
    return sorted({(608 * n.attrs['stride'] // n.stride, n.in_channels, n.attrs['filters'],
                    n.attrs['stride']) for n in net.graph.nodes
                   if n.kind == 'convolutional' and conv_route(n.attrs, n.in_channels) == 'c3'})


# ------------------------------------------------------------------ card

def card_equal_to_route(dev, n, h, w, cin, cout, stride, seed):
    gen = torch.Generator().manual_seed(seed)
    x, w3, wim, w_scale, b, colsum = (t.to(dev) for t in conv_inputs(gen, n, h, w, cin, cout))
    bad = []
    for requant, zp in ((True, 37.0), (False, 0.0), (True, 255.0)):
        sc = make_scalars(0.02, zp, 0.05 if requant else None, 101.0 if requant else None,
                          device=dev)
        got = qconv3x3_s8(x, w3, w_scale, b, colsum, act='leaky', stride=stride, scalars=sc,
                          requant=requant)
        want = route(x, wim, w_scale, b, colsum, stride, sc, requant, pw=qconv1x1_s8)
        torch.cuda.synchronize(dev)
        if not torch.equal(got, want):
            bad.append((requant, zp))
    return bad


@pytest.mark.cuda
@pytest.mark.parametrize('batch', [1, 2])
@pytest.mark.parametrize('shape', yolov3_shapes(), ids=lambda s: '-'.join(map(str, s)))
def test_card_every_yolov3_dense_3x3_equals_the_route(card, shape, batch):
    """At 608: the kernel against patches on the card into ``qconv1x1_s8``,
    byte for byte, s8 and f32 out, zero points 37, 0 and 255."""
    side, cin, cout, stride = shape
    assert card_equal_to_route(card, batch, side, side, cin, cout, stride, side * cin) == []


@pytest.mark.cuda
def test_card_at_the_cells_batch(card):
    """One shape at the cell's B=32: 76x76, Cin 128 -> 256 (184,832 output
    pixels, 1,444 row tiles)."""
    assert card_equal_to_route(card, 32, 76, 76, 128, 256, 1, 7) == []


@pytest.mark.cuda
@pytest.mark.parametrize('n,h,w,cin,cout,stride', [
    (4, 20, 36, 48, 75, 1), (4, 10, 14, 16, 24, 2), (4, 7, 9, 32, 256, 1), (4, 2, 2, 64, 128, 2)])
def test_card_edge_shapes_equal_the_plain_version(card, n, h, w, cin, cout, stride):
    """Cout 75 (byte stores), Cin 16 with Cout 24, odd sides, one output
    pixel: the kernel against its plain version, and against the route."""
    gen = torch.Generator().manual_seed(h * w + cout)
    x, w3, wim, w_scale, b, colsum = (t.to(card) for t in conv_inputs(gen, n, h, w, cin, cout))
    for requant in (True, False):
        sc = make_scalars(0.02, 90.0, 0.05 if requant else None, 60.0 if requant else None,
                          device=card)
        got = qconv3x3_s8(x, w3, w_scale, b, colsum, act='relu6', stride=stride, scalars=sc,
                          requant=requant)
        want = qconv3x3_reference(x, w3, w_scale, b, colsum, act='relu6', stride=stride,
                                  scalars=sc, requant=requant)
        torch.cuda.synchronize(card)
        assert torch.equal(got, want)
    assert card_equal_to_route(card, n, h, w, cin, cout, stride, 3) == []


@pytest.mark.cuda
def test_card_yolov3_walk_with_the_kernel_equals_the_walk_through_patches(card):
    """YOLOv3 in kernel mode at 320 px, B=2: every node's output and the
    preds with ``qconv3x3_s8`` equal those with its plain version on the
    same routes (the other kernels the same in both), byte for byte; 37
    launches."""
    net, qparams, x = calibrated(get_cfg('yolov3', num_classes=80), 320, dev=card)
    inf = Int8Inference(net)
    staged = Int8Inference.prepare(qparams, network=net)
    with torch.inference_mode():
        before = qconv3x3_s8.launches
        kern, ik = inf.apply(staged, x, intermediates=True)
        launches = qconv3x3_s8.launches - before
        plain, ip = inf.apply(staged, x, intermediates=True,
                              kernels=library.WRAPPERS._replace(qconv3x3=qconv3x3_reference))
    torch.cuda.synchronize()
    assert launches == 37
    assert sorted(ik) == sorted(ip)
    assert [k for k in ik if not torch.equal(ik[k], ip[k])] == []
    assert torch.equal(kern, plain)

