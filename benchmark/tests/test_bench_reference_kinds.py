"""The layer kinds and activations that the plain reference reads beside the
conv, shortcut, route, upsample and yolo of the frozen configurations:
maxpool, the global avgpool, scale_channels, mish and tanh.

- The frozen configurations read as they did before these kinds were
  added: their layers, map sides, counts and seeded weights against a
  snapshot (``reference_snapshot.json``) taken with the reference that read
  none of them.
- ``cfg.layers`` reads each new kind's shape facts, and still raises,
  naming the layer, on what it does not read.
- Each new operation against an independent definition in float64.
- Two whole graphs against the port's CPU path (f32 inference, int8
  calibration and the integer forward, the f32 train step): RegNetY-400MF-FPN
  from the port's zoo (squeeze-excite: avgpool, two BN-less 1x1s,
  scale_channels) and ``csp_spp_pan``, a narrow YOLOv4-style graph written
  here (mish, CSP routes, SPP's maxpools and 4-source route, a PAN with a
  stride-2 bottom-up path, three yolo heads).
"""

import hashlib
import json
import math
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from benchmark import counts, harness, weights
from benchmark.reference import cfg as C
from benchmark.reference import int8 as RQ
from benchmark.reference import net as RN
from benchmark.reference import train as RT

CONFIGS = harness.ROOT / 'benchmark' / 'configs'
SNAPSHOT = json.loads((Path(__file__).parent / 'reference_snapshot.json').read_text())


@pytest.fixture(autouse=True)
def two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------- cfg writers
class Cfg:
    """Darknet cfg text built section by section; ``add`` returns the new
    layer's index, and refs are given as absolute indices."""

    def __init__(self, channels=3):
        self.lines, self.index = ['[net]', f'channels={channels}', ''], -1

    def add(self, kind, **kv):
        self.lines.append(f'[{kind}]')
        for k, v in kv.items():
            self.lines.append(f"{k}={', '.join(map(str, v)) if isinstance(v, list) else v}")
        self.lines.append('')
        self.index += 1
        return self.index

    def rel(self, i):
        return i - self.index - 1

    def conv(self, filters, size=1, stride=1, act='leaky', bn=True):
        return self.add('convolutional', filters=filters, size=size, stride=stride, pad=1,
                        batch_normalize=int(bn), activation=act)

    def route(self, *refs):
        return self.add('route', layers=[self.rel(r) for r in refs] if len(refs) > 1
                        else self.rel(refs[0]))

    def text(self):
        return '\n'.join(self.lines)


def csp_spp_pan(width=8, blocks=(1, 1, 1, 1, 1), classes=20):
    """A YOLOv4-style detector (arXiv:2004.10934; darknet cfg/yolov4.cfg's
    topology) at stage widths ``width`` x 2, 4, 8, 16, 32: a mish stem and
    five CSP stages (a stride-2 3x3, a 1x1 kept aside, a 1x1 into
    ``blocks[k]`` residual blocks, a 1x1, the two-way route, a 1x1); a leaky
    neck with SPP (maxpools 5, 9 and 13 at stride 1, the 4-source route), a
    top-down path and a PAN's stride-2 3x3 bottom-up path; heads at strides
    8, 16 and 32."""
    b = Cfg()
    pred = 3 * (5 + classes)
    b.conv(width, 3, act='mish')
    taps = []
    for k, n in enumerate(blocks):
        c = width * 2 ** (k + 1)
        down = b.conv(c, 3, 2, act='mish')
        aside = b.conv(c // 2, act='mish')
        b.route(down)
        b.conv(c // 2, act='mish')
        for _ in range(n):
            block_in = b.index
            b.conv(c // 2, act='mish')
            b.conv(c // 2, 3, act='mish')
            b.add('shortcut', **{'from': b.rel(block_in), 'activation': 'linear'})
        b.conv(c // 2, act='mish')
        b.route(b.index, aside)
        taps.append(b.conv(c, act='mish'))
    c5 = width * 16
    b.conv(c5)
    b.conv(c5 * 2, 3)
    spp_in = b.conv(c5)
    pools = []
    for size in (5, 9, 13):
        if pools:
            b.route(spp_in)
        pools.append(b.add('maxpool', size=size, stride=1, pad=1))
    b.route(*pools[::-1], spp_in)
    b.conv(c5)
    b.conv(c5 * 2, 3)
    p5 = b.conv(c5)

    def five(c):
        for _ in range(2):
            b.conv(c)
            b.conv(c * 2, 3)
        return b.conv(c)
    tops = {32: p5}
    for stride, tap in ((16, taps[3]), (8, taps[2])):
        c = width * (stride // 2)
        b.conv(c)
        up = b.add('upsample', stride=2)
        b.route(tap)
        lateral = b.conv(c)
        b.route(lateral, up)
        tops[stride] = five(c)

    def head(c):
        b.conv(c * 2, 3)
        b.conv(pred, act='linear', bn=False)
        b.add('yolo', classes=classes)
    head(width * 4)
    node = tops[8]
    for stride in (16, 32):
        c = width * (stride // 2)
        b.route(node)
        down = b.conv(c, 3, 2)
        b.route(down, tops[stride])
        node = five(c)
        head(c)
    return b.text()


def regnety_400m_fpn():
    from pqdet_tpu_torch.zoo import get_cfg
    return get_cfg('regnety-400m-fpn')


GRAPHS = {'ry400': (regnety_400m_fpn, 1.5), 'csp': (csp_spp_pan, 1.5)}


def setup(name, size=64, b=2, seed=0):
    text = GRAPHS[name][0]()
    lays = C.layers(text)
    params, state = weights.make(lays, torch.Generator().manual_seed(seed), GRAPHS[name][1],
                                 'cpu')
    u8 = torch.randint(0, 256, (b, size, size, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(seed + 1))
    return text, lays, params, state, u8


# ------------------------------------------- the frozen cfgs, as before
def digest(obj):
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


def tensors_digest(params, state):
    h = hashlib.sha256()

    def feed(name, t):
        if isinstance(t, dict):
            for k in sorted(t):
                feed(f'{name}/{k}', t[k])
        else:
            h.update(name.encode())
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
    for key in params:
        feed('p' + key, params[key])
    for key in state:
        feed('s' + key, state[key])
    return h.hexdigest()


@pytest.mark.parametrize('name', sorted(SNAPSHOT))
def test_frozen_cfgs_read_as_before(name):
    snap = SNAPSHOT[name]
    size, batch = snap['size'], snap['batch']
    lays = C.layers((CONFIGS / f'{name}.cfg').read_text())
    chains = counts.fused_chains(lays)
    assert digest(lays) == snap['layers']
    assert digest(C.out_sides(lays, size)) == snap['out_sides']
    assert counts.forward_ops(lays, size) == snap['forward_ops']
    assert counts.qconv1x1_bound_s(lays, size, batch) == snap['qconv1x1_bound_s']
    assert [list(c) for c in chains] == snap['fused_chains']
    assert [counts.fused_chain_bound_s(lays, c, size, batch)
            for c in chains] == snap['fused_chain_bound_s']


@pytest.mark.parametrize('name', sorted(SNAPSHOT))
def test_frozen_cfgs_draw_the_same_weights(name):
    snap = SNAPSHOT[name]
    lays = C.layers((CONFIGS / f'{name}.cfg').read_text())
    params, state = weights.make(lays, torch.Generator().manual_seed(0), snap['gain'], 'cpu')
    assert tensors_digest(params, state) == snap['weights']


def test_new_kinds_draw_no_weights():
    """A pool or scale_channels between two convs leaves the convs' draws
    as they are without it."""
    def cfg(extra):
        b = Cfg()
        first = b.conv(8, 3, 2)
        if extra:
            b.add('maxpool', size=5, stride=1, pad=1)
            b.add('avgpool')
            b.conv(8, act='logistic', bn=False)
            b.add('scale_channels', **{'from': b.rel(first)})
        b.conv(16, 3)
        return C.layers(b.text())
    plain, extra = cfg(False), cfg(True)
    p0, s0 = weights.make(plain, torch.Generator().manual_seed(3), 1.0, 'cpu')
    p1, s1 = weights.make(extra, torch.Generator().manual_seed(3), 1.0, 'cpu')
    assert torch.equal(p0['0']['w'], p1['0']['w']) and torch.equal(s0['0']['var'], s1['0']['var'])
    assert set(p1) == {'0', '3', '5'} and p1['3']['b'].shape == (8,)


# ------------------------------------------------------------ the reader
def pool_case(size, stride, pad):
    b = Cfg(8)
    b.conv(16, 3, 2)
    b.add('maxpool', size=size, stride=stride, **({'pad': 1} if pad else {}))
    return b.text(), 1, dict(cin=16, cout=16, stride_total=2 * stride, side=32 // stride,
                             pad=size // 2 if pad else 0)


def spp_case():
    b = Cfg(8)
    spp_in = b.conv(16, 3, 2)
    pools = []
    for size in (5, 9, 13):
        if pools:
            b.route(spp_in)
        pools.append(b.add('maxpool', size=size, stride=1, pad=1))
    i = b.route(*pools[::-1], spp_in)
    return b.text(), i, dict(cin=16, cout=64, refs=[5, 3, 1, 0], stride_total=2, side=32)


def se_case(at):
    b = Cfg(8)
    gconv = b.conv(16, 3, 2)
    b.add('avgpool')
    b.conv(4, act='relu', bn=False)
    b.conv(16, act='logistic', bn=False)
    b.add('scale_channels', **{'from': b.rel(gconv)})
    b.conv(32)
    want = {1: dict(cin=16, cout=16, stride_total=2, side=1, pooled=True),
            2: dict(cin=16, cout=4, stride_total=2, side=1, pooled=True),
            3: dict(cin=4, cout=16, stride_total=2, side=1, pooled=True),
            4: dict(cin=16, cout=16, refs=[0], stride_total=2, side=32, pooled=None),
            5: dict(cin=16, cout=32, stride_total=2, side=32, pooled=None)}[at]
    return b.text(), at, want


READER_CASES = {
    'maxpool-2-2': lambda: pool_case(2, 2, False),
    'maxpool-3-2-pad': lambda: pool_case(3, 2, True),
    'maxpool-5-1-pad': lambda: pool_case(5, 1, True),
    'maxpool-9-1-pad': lambda: pool_case(9, 1, True),
    'maxpool-13-1-pad': lambda: pool_case(13, 1, True),
    'spp-route': spp_case,
    **{f'se-{at}': (lambda at=at: se_case(at)) for at in range(1, 6)},
}


@pytest.mark.parametrize('case', sorted(READER_CASES))
def test_reader_reads_the_new_kinds(case):
    text, i, want = READER_CASES[case]()
    lays = C.layers(text)
    lay = lays[i]
    assert (lay['cin'], lay['cout'], lay['stride_total']) == \
        (want['cin'], want['cout'], want['stride_total'])
    assert lay.get('refs') == want.get('refs')
    assert C.out_sides(lays, 64)[i] == want['side']
    if 'pad' in want:
        assert lay['pad'] == want['pad']
    if 'pooled' in want:
        assert lay.get('pooled') == want['pooled']
        assert lay.get('global') == (True if lay['kind'] == 'avgpool' else None)


def test_forward_ops_leave_pools_out_and_see_the_pooled_side():
    lays = C.layers(se_case(2)[0])
    sides = C.out_sides(lays, 64)
    want_ops = [2 * 9 * 8 * 16 * 32 * 32, 2 * 16 * 4, 2 * 4 * 16, 2 * 16 * 32 * 32 * 32]
    assert [counts.conv_ops(l, sides[l['index']]) for l in C.conv_layers(lays)] == want_ops
    assert counts.forward_ops(lays, 64) == sum(want_ops)
    cons = counts._consumers(lays)
    assert cons[0] == [1, 4] and cons[3] == [4]
    # the squeeze conv reads the pooled 1 x 1 map: 16 input bytes an image
    only = [l if l['index'] == 2 else {**l, 'kind': 'x'} for l in lays]
    nbytes = 80 * 16 + 16 * 4 + 12 * 4 + 80 * 4
    want = max(nbytes / counts.HBM_BYTES_PER_S, 80 * 2 * 16 * 4 / counts.INT8_OP_PER_S)
    assert counts.qconv1x1_bound_s(only, 64, 80) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize('section', [
    '[fc]\noutput=10', '[dropout]\nprobability=0.5', '[reorg]\nstride=2', '[local]\nfilters=4',
    '[avgpool]\nheight=2\nwidth=2', '[maxpool]\nsize=3\nstride=1',
    '[maxpool]\nsize=2\nstride=1\npad=1', '[maxpool]\nsize=2\nstride=2\npadding=1'],
    ids=['fc', 'dropout', 'reorg', 'local', 'avgpool-2x2', 'maxpool-shrinks',
         'maxpool-grows', 'maxpool-2-2-padded'])
def test_reader_still_raises_naming_the_layer(section):
    text = '[net]\nchannels=3\n\n[convolutional]\nfilters=8\nsize=3\npad=1\n\n' + section
    with pytest.raises(ValueError, match='layer 1'):
        C.layers(text)


# ------------------------------------- operations against definitions
@pytest.mark.parametrize('size,stride,pad', [(2, 2, 0), (3, 2, 1), (5, 1, 2), (9, 1, 4),
                                             (13, 1, 6)])
def test_maxpool_against_a_loop_over_windows(size, stride, pad):
    x = -1 - torch.rand(2, 3, 12, 12, generator=torch.Generator().manual_seed(size),
                        dtype=torch.float64)     # all below 0: a zero-padded cell would win
    lay = {'kind': 'maxpool', 'size': size, 'stride': stride, 'pad': pad}
    got = RN.pool_or_scale(lay, x.float(), {}).double()
    side = 12 // stride
    want = torch.empty(2, 3, side, side, dtype=torch.float64)
    for i in range(side):
        for j in range(side):
            r0, c0 = i * stride - pad, j * stride - pad
            rows = range(max(r0, 0), min(r0 + size, 12))
            cols = range(max(c0, 0), min(c0 + size, 12))
            want[:, :, i, j] = x[:, :, rows.start:rows.stop, cols.start:cols.stop].amax((2, 3))
    assert got.shape == want.shape
    assert (got - want).abs().max() < 1e-6


@pytest.mark.parametrize('name', ['mish', 'tanh'])
def test_activation_against_float64(name):
    x = torch.linspace(-30, 30, 6001, dtype=torch.float64)
    if name == 'mish':
        want = torch.tensor([v * math.tanh(math.log1p(math.exp(v))) for v in x.tolist()],
                            dtype=torch.float64)
    else:
        want = torch.tensor([math.tanh(v) for v in x.tolist()], dtype=torch.float64)
    got = RN.ACTS[name](x.float()).double()
    assert ((got - want).abs() / want.abs().clamp_min(1.0)).max() < 1e-6


def test_squeeze_excite_against_its_definition():
    text, _, _ = se_case(5)
    lays = C.layers(text)
    params, state = weights.make(lays, torch.Generator().manual_seed(4), 1.0, 'cpu')
    x = torch.randn(2, 8, 64, 64, generator=torch.Generator().manual_seed(5))
    seen = {}

    def conv(l, t):
        w, b = RN.fold(params[str(l['index'])], state.get(str(l['index'])))
        y = RN.ACTS[l['act']](F.conv2d(t, w, b, l['stride'], l['pad'], 1, l['groups']))
        seen[l['index']] = y
        return y
    RN.walk(lays, x, conv)
    z = seen[0].double()                                           # (2, 16, 32, 32)
    pooled = torch.stack([torch.stack([z[n, c].sum() / z[n, c].numel() for c in range(16)])
                          for n in range(2)])                      # (2, 16)
    w1, b1 = params['2']['w'].double()[:, :, 0, 0], params['2']['b'].double()
    w2, b2 = params['3']['w'].double()[:, :, 0, 0], params['3']['b'].double()
    hidden = (pooled @ w1.T + b1).clamp_min(0)
    gate = 1 / (1 + torch.exp(-(hidden @ w2.T + b2)))
    want = z * gate[:, :, None, None]
    scaled = seen[5].double()                 # the conv after scale_channels reads it
    w5, b5 = RN.fold(params['5'], state['5'])
    got = F.conv2d(want, w5.double(), b5.double())
    assert (RN.ACTS['leaky'](got) - scaled).abs().max() < 1e-4 * scaled.abs().max()


# --------------------------------------- whole graphs against the port
@pytest.mark.parametrize('name', sorted(GRAPHS))
def test_float_forward_matches_the_port(name):
    from pqdet_tpu_torch.model.network import DetectionNetwork
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    text, lays, params, state, u8 = setup(name)
    net = DetectionNetwork.from_cfg(text)
    assert [n.kind for n in net.graph.nodes] == [l['kind'] for l in lays]
    assert [n.out_channels for n in net.graph.nodes] == [l['cout'] for l in lays]
    with torch.no_grad():
        port = net(params, state, device_normalize(u8), plain=True)
    ref = RN.infer(lays, params, state, RN.normalize(u8))
    scale = ref.abs().amax(dim=(0, 1))
    assert ((port - ref).abs().amax(dim=(0, 1)) / scale).max() < 1e-4


@pytest.mark.parametrize('name', sorted(GRAPHS))
def test_int8_calibration_and_forward_match_the_port(name):
    from pqdet_tpu_torch.compress.qat import QuantCtx, prepare_qat_state
    from pqdet_tpu_torch.compress.quantized import Int8Inference, convert_to_int8
    from pqdet_tpu_torch.model.network import DetectionNetwork
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    text, lays, params, state, u8 = setup(name)
    qnet = DetectionNetwork.from_cfg(text, quant=True)
    qp, qs = prepare_qat_state(qnet, params, state)
    with torch.no_grad():
        for _ in range(2):
            ctx = QuantCtx(qs['quant'], observing=True)
            qnet(qp, qs, device_normalize(u8), quant_ctx=ctx)
            qs = {**qs, 'quant': ctx.new_obs}
        qparams = convert_to_int8(qnet, qp, qs)
        port = Int8Inference(qnet, mode='int').apply(
            Int8Inference.prepare(qparams, mode='int'), device_normalize(u8))
    x = RN.normalize(u8)
    obs = RQ.calibrate(lays, params, state, [x, x])
    model = RQ.convert(lays, params, state, obs)
    new = {str(l['index']) for l in lays if l['kind'] in RN.POOL_OR_SCALE}
    assert new and new <= set(model[1])               # every pool and scale has its edge
    assert set(model[1]) == set(qparams['act'])
    for edge, (s, zp) in model[1].items():
        ps, pzp = qparams['act'][edge]
        # as test_bench_reference: a range is an extreme, and codes that round
        # the other way upstream move a deep edge's by a few codes
        assert abs(s - ps) <= 3e-2 * ps and abs(zp - pzp) <= 3
    ref = RQ.infer(lays, model, x).float()
    scores = lambda p: p[..., 4:5] * p[..., 5:]  # noqa: E731
    assert (scores(port) - scores(ref)).abs().max() < 0.02


@pytest.mark.parametrize('name', sorted(GRAPHS))
def test_train_step_matches_the_port_in_float32(name):
    from pqdet_tpu_torch.config import Config
    from pqdet_tpu_torch.model.network import DetectionNetwork
    from pqdet_tpu_torch.ops.labels import label_assigner_from_config
    from pqdet_tpu_torch.train.step import make_loss_fn, value_and_grad
    from benchmark.train import make_pool
    spec = harness.load_spec()
    t = harness.load_cell(spec, 'mnv2-train-bf16-b32')['traffic']
    t = {**t, 'batch': 4, 'size': 64, 'pool': 1}
    text, lays, params, state, _ = setup(name)
    batch = make_pool(t, 20, torch.Generator().manual_seed(5), 'cpu')[0]
    cfg = Config()
    cfg.model.anchors = t['anchors']
    labels = label_assigner_from_config(cfg, device='cpu')
    net = DetectionNetwork.from_cfg(text)
    loss_fn = make_loss_fn(net, label_fn=labels)
    (loss, (_, port_state, _)), port_grads = value_and_grad(loss_fn, params, state, batch)
    flipped = {k: v.flip(0) for k, v in batch.items()}
    _, port_flipped = value_and_grad(loss_fn, params, state, flipped)
    model = {'strides': t['strides'], 'anchors': t['anchors'], 'classes': 20}
    ref, grads, ref_state = RT.loss_and_grads(lays, params, state, batch['image'], batch['gt'],
                                              model)
    _, ref_flipped, _ = RT.loss_and_grads(lays, params, state, flipped['image'],
                                          flipped['gt'], model)
    assert abs(float(loss) - float(ref)) <= 1e-4 * abs(float(ref))
    # each leaf's gradient, the SE convs' weights and biases among them, as a
    # gap to the reference against the larger of its norm and the median
    # leaf's; held to the gap between each side's step and its own step on
    # the batch reversed (the same sum in another order), as far as rounding
    # carries through the batch statistics of the walk
    floor = torch.stack([g.norm() for g in grads]).median()

    def worst(a, b):
        return max(float((x - y).norm() / torch.maximum(y.norm(), floor)) for x, y in zip(a, b))
    noise = max(worst(ref_flipped, grads),
                worst(RT.leaves(port_flipped), RT.leaves(port_grads)))
    assert worst(RT.leaves(port_grads), grads) <= 3 * noise
    assert set(ref_state) <= set(port_state)
    for key, s in ref_state.items():
        for k in ('mean', 'var'):
            assert (port_state[key][k] - s[k]).abs().max() <= 1e-4 * s[k].abs().max()
