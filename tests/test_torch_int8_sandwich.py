"""The int8 sandwich (``ops/qconv.py::int8_sandwich``, ``csrc/qconv.cu``):
the input's quantisation, each shortcut and each route of the int8 walk as
one launch from s8 to s8.

On the CPU: the wrapper runs the walk's PyTorch chain exactly; the
registered operator's fake function; the walk's choice of nodes, its
route table (``Int8Inference.routes``); an exported kernel program calls
the operator. On the card (marker ``cuda``, skipped elsewhere; run there
with ``python -m pytest -m cuda tests/test_torch_int8_sandwich.py``): the
kernel equals the same chain on the same CUDA tensors byte for byte, at
every form and the walk's shapes, on .5 ties, saturation and unequal
scales, and a whole regnetx-600m-fpn walk with the kernel equals the walk
with the chain node by node.

The chain is ``compress/quantized.py``'s (``ops/qconv.py::dequant_s8`` and
``quant_s8``): dequant ``(s - (zp - 128)) * scale`` of each source, the op
and the activation, then ``y / scale + (zp - 128)``, round half to even,
clamp. Its division of an f32 tensor by a Python scalar runs on the card
as a multiply by the f32 reciprocal of the f32 scalar:
``test_card_divides_by_a_scalar_through_its_reciprocal`` pins that, since
the kernel repeats it.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from pqdet_tpu_torch.compress.qat import QuantCtx, prepare_qat_state
from pqdet_tpu_torch.compress.quantized import Int8Inference, convert_to_int8
from pqdet_tpu_torch.exporters.export import export_stablehlo_quant, load_stablehlo
from pqdet_tpu_torch.model import layers as L
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.ops import library, qconv
from pqdet_tpu_torch.ops.qconv import (dequant_s8, int8_sandwich, int8_sandwich_reference,
                                       quant_s8, sandwich_scalars)
from pqdet_tpu_torch.zoo import get_cfg
from pqdet_tpu_torch.zoo.builder import CfgBuilder


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small CPU ops, beside the
    suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    """The CUDA device; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA card: the sandwich kernel runs only there')
    return torch.device('cuda', 0)


def chain(srcs, edges, out_edge, form, act='linear'):
    """The walk's PyTorch chain (``Int8Inference.apply``: ``dequant_s8``,
    ``_f32_node``'s op and activation, ``quant_s8``), the edges as Python
    floats."""
    if form == 'input':
        return quant_s8(srcs[0], out_edge[0], out_edge[1] - 128.0)
    ys = [dequant_s8(t, e[0], e[1] - 128.0) for t, e in zip(srcs, edges)]
    if form == 'shortcut':
        y = L.apply_activation(act, ys[0] + ys[1])
    else:
        y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=-1)
    return quant_s8(y, out_edge[0], out_edge[1] - 128.0)


def f32(v):
    """An edge's scale as ``act_qparams`` gives it: an f32 value as a
    Python float."""
    return float(np.float32(v))


def make_case(rng, form, lead, chans, ties):
    """(srcs, source edges, out edge) on the CPU. ``ties``: source scales 3
    and 1 and an out scale of 2, so that y / 2 lands on .5 ties wherever y
    is odd, and past both ends of the code range; else unequal random
    scales and zero points."""
    n_q = 0 if form == 'input' else len(chans)
    if ties:
        edges = [((3.0, 1.0)[j % 2], float(rng.randint(96, 161))) for j in range(n_q)]
        out_edge = (2.0, float(rng.randint(112, 145)))
    else:
        edges = [(f32(rng.uniform(0.004, 0.06)), float(rng.randint(0, 256)))
                 for _ in range(n_q)]
        out_edge = (f32(rng.uniform(0.004, 0.06)), float(rng.randint(0, 256)))
    if form == 'input':
        shape = (*lead, chans[0])
        if ties:        # (k + 1/2) * scale, k across and past the code range
            x = (rng.randint(-300, 300, shape) + 0.5) * out_edge[0]
        else:
            x = rng.randn(*shape) * 2.0
        return [torch.from_numpy(x.astype(np.float32))], edges, out_edge
    srcs = [torch.from_numpy(rng.randint(-128, 128, (*lead, c)).astype(np.int8))
            for c in chans]
    return srcs, edges, out_edge


def run_case(form, srcs, edges, out_edge, act, dev):
    """(kernel or wrapper output, chain output) on ``dev``."""
    srcs = [t.to(dev) for t in srcs]
    sc = sandwich_scalars(edges, out_edge, dev)
    return (int8_sandwich(srcs, sc, form=form, act=act),
            chain(srcs, edges, out_edge, form, act))


# (form, leading N, H, W, channels of each source, activation)
CPU_CASES = [
    ('input', (2, 8, 8), (3,), 'linear'),
    ('shortcut', (2, 4, 4), (24, 24), 'linear'),
    ('shortcut', (1, 3, 5), (48, 48), 'relu'),
    ('shortcut', (2, 2, 3), (13, 13), 'leaky'),
    ('route', (2, 4, 4), (32,), 'linear'),
    ('route', (1, 4, 4), (88, 96), 'linear'),
    ('route', (2, 3, 3), (8, 13, 16), 'linear'),
]


@pytest.mark.parametrize('ties', [True, False], ids=['ties', 'random'])
@pytest.mark.parametrize('form,lead,chans,act', CPU_CASES,
                         ids=[f'{c[0]}-{"+".join(map(str, c[2]))}-{c[3]}' for c in CPU_CASES])
def test_wrapper_on_the_cpu_is_the_walks_chain(form, lead, chans, act, ties):
    rng = np.random.RandomState(len(chans) * 100 + sum(chans) + ties)
    srcs, edges, out_edge = make_case(rng, form, lead, chans, ties)
    got, want = run_case(form, srcs, edges, out_edge, act, torch.device('cpu'))
    ref = int8_sandwich_reference(srcs, sandwich_scalars(edges, out_edge, 'cpu'), form=form,
                                  act=act)
    assert got.dtype == torch.int8 and torch.equal(got, want) and torch.equal(ref, want)
    if ties:        # the data saturates (at both ends before an activation)
        assert int(want.max()) == 127 and (act != 'linear' or int(want.min()) == -128)


@pytest.mark.parametrize('form,chans,want', [
    ('input', (3,), (2, 5, 7, 3)), ('shortcut', (48, 48), (2, 5, 7, 48)),
    ('route', (48,), (2, 5, 7, 48)), ('route', (88, 96, 13), (2, 5, 7, 197))])
def test_operator_fake_gives_shape_and_dtype(form, chans, want):
    with FakeTensorMode():
        dtype = torch.float32 if form == 'input' else torch.int8
        srcs = [torch.empty((2, 5, 7, c), dtype=dtype) for c in chans]
        n_q = 0 if form == 'input' else len(chans)
        sc = torch.empty((2 * n_q + 2,), dtype=torch.float32)
        out = torch.ops.pqdet.int8_sandwich(srcs, sc, form, 'linear')
    assert tuple(out.shape) == want and out.dtype == torch.int8
    assert 'int8_sandwich' in library.OP_NAMES and library.OPS.sandwich is library.int8_sandwich


@pytest.mark.parametrize('form,srcs,n_sc,act,match', [
    ('shortcut', [(2, 4, 4, 8), (2, 4, 4, 16)], 6, 'linear', 'srcs\\[1\\]'),
    ('route', [(2, 4, 4, 8), (2, 4, 5, 8)], 6, 'linear', 'srcs\\[1\\]'),
    ('shortcut', [(2, 4, 4, 8)] * 2, 6, 'logistic', 'activation'),
    ('route', [(2, 4, 4, 8)], 4, 'relu', 'activation'),
    ('route', [(2, 4, 4, 8)] * 2, 4, 'linear', 'scalars'),
    ('input', [(2, 4, 4, 3)], 2, 'linear', 'srcs\\[0\\]'),
])
def test_checks_refuse_what_the_kernel_does_not_take(form, srcs, n_sc, act, match):
    """The checks the wrapper runs before a launch, on meta tensors."""
    ts = [torch.empty(s, dtype=torch.int8, device='meta') for s in srcs]
    sc = torch.empty((n_sc,), dtype=torch.float32, device='meta')
    with pytest.raises(ValueError, match=match):
        qconv._check_sandwich(ts, sc, form, act)


def test_meta_tensors_give_the_shape_only():
    """A meta tensor stands in for the card in the walk's tests: the
    wrapper checks it and gives the output's shape, launching nothing."""
    srcs = [torch.empty((2, 3, 5, c), dtype=torch.int8, device='meta') for c in (88, 96)]
    sc = torch.empty((6,), dtype=torch.float32, device='meta')
    before = int8_sandwich.launches
    out = int8_sandwich(srcs, sc, form='route')
    assert out.device.type == 'meta' and tuple(out.shape) == (2, 3, 5, 184)
    assert out.dtype == torch.int8 and int8_sandwich.launches == before


def small_cfg(nc=3):
    """A shortcut, a max pool, an SE scale_channels and a two-source route."""
    b = CfgBuilder()
    b.conv(16, size=3, stride=2, activation='relu')            # 0
    b.conv(16, size=1, activation='linear')                    # 1
    b.shortcut(0, activation='relu')                           # 2
    b.maxpool(2, 2)                                            # 3
    se_in = b.conv(24, size=1, activation='relu')              # 4
    b.avgpool()                                                # 5
    b.conv(8, size=1, bn=False, activation='relu')             # 6
    b.conv(24, size=1, bn=False, activation='logistic')        # 7
    b.scale_channels(se_in)                                    # 8
    b.route([8, 3])                                            # 9
    b.conv(3 * (5 + nc), size=1, bn=False, activation='linear')  # 10
    b.yolo(nc)                                                 # 11
    return b.text()


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


def sandwich_counts(net, qparams, x, mode='kernel', plain=False):
    """(preds, (nodes the route table gives ``int8_sandwich``, nodes it
    leaves to the chain)) of one walk through the wrappers or (``plain``)
    their plain versions, the input and every node between a dequant and
    a requant counted; the walk calls the sandwich entry once a node the
    table gives it."""
    inf = Int8Inference(net, mode=mode)
    staged = Int8Inference.prepare(qparams, mode, network=net)
    table, calls = library.PLAIN if plain else library.WRAPPERS, []

    def sandwich(*args, **kw):
        calls.append(kw['form'])
        return table.sandwich(*args, **kw)
    with torch.inference_mode():
        preds = inf.apply(staged, x, kernels=table._replace(sandwich=sandwich))
    convs = {str(n.index) for n in net.graph.nodes if n.kind == 'convolutional'}
    routes = [r for k, r in inf.routes(qparams['act']).items() if k not in convs]
    assert len(calls) == routes.count('sandwich')
    return preds, (routes.count('sandwich'), routes.count(None))


@pytest.mark.parametrize('mode,plain,want', [('kernel', False, (3, 3)), ('kernel', True, (3, 3)),
                                             ('int', True, (0, 6))])
def test_counters_on_a_small_graph(mode, plain, want):
    """Kernel mode takes the input, the shortcut and the route, with the
    kernel or (``plain``) its plain version; the max pool, the SE's
    avgpool and scale keep the chain, as do all six in the other modes.
    The kernel path's preds equal the plain walk's, whose
    ``int8_sandwich_reference`` is the chain."""
    net, qparams, x = calibrated(small_cfg(), 32)
    preds, counts = sandwich_counts(net, qparams, x, mode=mode, plain=plain)
    assert counts == want
    if mode == 'kernel' and not plain:
        ref, _ = sandwich_counts(net, qparams, x, plain=True)
        assert torch.equal(preds, ref)


@pytest.mark.parametrize('name,fused', [('regnetx-600m-fpn', 37), ('mobilenetv2-fpn', 15)])
def test_every_sandwich_of_the_zoo_graphs_is_fused(name, fused):
    """regnetx-600m-fpn: 25 shortcuts, 11 routes and the input;
    mobilenetv2-fpn: 10 shortcuts, 4 routes and the input."""
    net, qparams, x = calibrated(get_cfg(name), 64, batch=1)
    _, counts = sandwich_counts(net, qparams, x)
    assert counts == (fused, 0)


def test_exported_kernel_program_calls_the_sandwich(tmp_path):
    """An exported ``'kernel'`` program holds the operator once per node the
    eager walk fuses and gives the eager walk's preds."""
    net, qparams, x = calibrated(small_cfg(), 32)
    fn = load_stablehlo(export_stablehlo_quant(net, qparams, (32, 32), 2, 'kernel',
                                               device='cpu'), device='cpu')
    assert library.graph_ops(fn).count('pqdet.int8_sandwich.default') == 3
    inf = Int8Inference(net)
    with torch.inference_mode():
        want = inf.apply(Int8Inference.prepare(qparams, network=net), x)
        assert torch.equal(fn(x), want)


# ---------------------------------------------------------------- the card

@pytest.mark.cuda
def test_card_divides_by_a_scalar_through_its_reciprocal(card):
    """The chain's ``y / scale`` on CUDA is ``y * fl32(1 / fl32(scale))``, the
    kernel's ``__frcp_rn``, and not the correctly rounded quotient (the
    two differ on this data)."""
    rng = np.random.RandomState(0)
    y = torch.from_numpy(rng.randn(1 << 20).astype(np.float32) * 50).to(card)
    for scale in (0.0173, 0.3, f32(0.047), 3.0):
        got = y / scale
        inv = np.float32(1.0) / np.float32(scale)
        assert torch.equal(got, y * float(inv))
        assert not torch.equal(got, y / torch.tensor(scale, dtype=torch.float32, device=card))


# (form, leading N, H, W, channels of each source, activation): the kernel's
# forms, widths and odd counts, and the walk's shapes up to the cell's
CARD_CASES = [
    ('shortcut', (1, 1, 1), (8, 8), 'linear'),
    ('shortcut', (3, 5, 7), (24, 24), 'relu'),
    ('shortcut', (2, 3, 3), (13, 13), 'leaky'),
    ('shortcut', (80, 64, 64), (96, 96), 'relu'),
    ('shortcut', (80, 128, 128), (48, 48), 'relu'),
    ('shortcut', (4, 32, 32), (160, 160), 'linear'),
    ('shortcut', (4, 16, 16), (528, 528), 'leaky'),
    ('route', (1, 1, 1), (8,), 'linear'),
    ('route', (80, 256, 256), (32,), 'linear'),
    ('route', (80, 32, 32), (88, 96), 'linear'),
    ('route', (80, 32, 32), (176, 240), 'linear'),
    ('route', (80, 64, 64), (80, 96), 'linear'),
    ('route', (4, 16, 16), (256, 96), 'linear'),
    ('route', (3, 5, 7), (8, 13, 16), 'linear'),
    ('route', (2, 9, 9), (176, 240, 88), 'linear'),
    ('input', (1, 1, 1), (3,), 'linear'),
    ('input', (3, 5, 7), (3,), 'linear'),
    ('input', (80, 512, 512), (3,), 'linear'),
]


@pytest.mark.cuda
@pytest.mark.parametrize('ties', [True, False], ids=['ties', 'random'])
@pytest.mark.parametrize('form,lead,chans,act', CARD_CASES,
                         ids=[f'{c[0]}-{"x".join(map(str, c[1]))}-{"+".join(map(str, c[2]))}'
                              f'-{c[3]}' for c in CARD_CASES])
def test_card_kernel_equals_the_chain(card, form, lead, chans, act, ties):
    rng = np.random.RandomState(sum(lead) * 7 + sum(chans) + ties)
    srcs, edges, out_edge = make_case(rng, form, lead, chans, ties)
    before = int8_sandwich.launches
    with torch.inference_mode():
        got, want = run_case(form, srcs, edges, out_edge, act, card)
    torch.cuda.synchronize()
    assert int8_sandwich.launches == before + 1
    assert got.dtype == torch.int8 and got.shape == want.shape
    n_diff = int((got != want).sum())
    assert n_diff == 0, f'{n_diff} of {got.numel()} codes differ'
    if ties and got.numel() >= 4096:
        assert int(want.max()) == 127 and (act != 'linear' or int(want.min()) == -128)


@pytest.mark.cuda
def test_card_walk_with_the_kernel_equals_the_walk_with_the_chain(card):
    """regnetx-600m-fpn in kernel mode at 256 px, B=2: every node's output
    and the preds with the sandwich kernel equal those with the PyTorch
    chain (the other kernels the same in both), byte for byte."""
    net, qparams, x = calibrated(get_cfg('regnetx-600m-fpn'), 256, dev=card)
    inf = Int8Inference(net)
    staged = Int8Inference.prepare(qparams, network=net)
    with torch.inference_mode():
        before = int8_sandwich.launches
        kern, ik = inf.apply(staged, x, intermediates=True)
        launches = int8_sandwich.launches - before
        plain, ip = inf.apply(staged, x, intermediates=True, kernels=library.WRAPPERS._replace(
            sandwich=int8_sandwich_reference))
    torch.cuda.synchronize()
    assert launches == 37
    assert sorted(ik) == sorted(ip)
    assert [k for k in ik if not torch.equal(ik[k], ip[k])] == []
    assert torch.equal(kern, plain)
