"""The plain reference against the port's CPU path at a small size, and the
reference's independence from the port and from JAX."""

import ast

import numpy as np
import pytest
import torch

from benchmark import harness, weights
from benchmark.reference import cfg as C
from benchmark.reference import int8 as RQ
from benchmark.reference import net as RN
from benchmark.reference import post as RP
from benchmark.reference import train as RT

REF_DIR = harness.ROOT / 'benchmark' / 'reference'
CFGS = {'mnv2': harness.ROOT / 'benchmark' / 'configs' / 'mobilenetv2-fpn.cfg',
        'rx600': harness.ROOT / 'benchmark' / 'configs' / 'regnetx-600m-fpn.cfg'}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('path', sorted(REF_DIR.glob('*.py')), ids=lambda p: p.name)
def test_reference_imports_neither_the_port_nor_jax(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    assert not names & {'jax', 'jaxlib', 'flax', 'pqdet_tpu', 'pqdet_tpu_torch'}, names


def setup(name, gain, size=64, b=2, seed=0):
    text = CFGS[name].read_text()
    lays = C.layers(text)
    params, state = weights.make(lays, torch.Generator().manual_seed(seed), gain, 'cpu')
    u8 = torch.randint(0, 256, (b, size, size, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(seed + 1))
    return text, lays, params, state, u8


@pytest.mark.parametrize('name,gain', [('mnv2', 2.0), ('rx600', 1.5)])
def test_float_forward_matches_the_port(name, gain):
    from pqdet_tpu_torch.model.network import DetectionNetwork
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    text, lays, params, state, u8 = setup(name, gain)
    net = DetectionNetwork.from_cfg(text)
    with torch.no_grad():
        port = net(params, state, device_normalize(u8), plain=True)
    ref = RN.infer(lays, params, state, RN.normalize(u8))
    scale = ref.abs().amax(dim=(0, 1))
    assert ((port - ref).abs().amax(dim=(0, 1)) / scale).max() < 1e-4


def test_int8_calibration_and_forward_match_the_port():
    from pqdet_tpu_torch.compress.qat import QuantCtx, prepare_qat_state
    from pqdet_tpu_torch.compress.quantized import Int8Inference, convert_to_int8
    from pqdet_tpu_torch.model.network import DetectionNetwork
    from pqdet_tpu_torch.ops.preprocess import device_normalize
    text, lays, params, state, u8 = setup('rx600', 1.5)
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
    for edge, (s, zp) in model[1].items():
        ps, pzp = qparams['act'][edge]
        # a range is an extreme, and codes that round the other way upstream
        # (ties, a division rounded another way) move a deep edge's by a few codes
        assert abs(s - ps) <= 3e-2 * ps and abs(zp - pzp) <= 3
    ref = RQ.infer(lays, model, x).float()
    scores = lambda p: p[..., 4:5] * p[..., 5:]  # noqa: E731
    assert (scores(port) - scores(ref)).abs().max() < 0.02


def test_nms_matches_the_port():
    from pqdet_tpu_torch.ops.postprocess import nms_batch
    g = torch.Generator().manual_seed(3)
    xy = torch.rand(2, 300, 2, generator=g) * 200
    boxes = torch.cat([xy, xy + 5 + torch.rand(2, 300, 2, generator=g) * 60], -1)
    scores = torch.rand(2, 300, 4, generator=g)
    res = nms_batch(torch.cat([boxes, scores], -1), 0.1, 0.45, 64, 4)
    ref = RP.nms(boxes, scores, 0.1, 0.45, 64, 4)
    for j in range(2):
        keep = res.valid[j].numpy()
        port = np.concatenate([res.boxes[j][keep].numpy(), res.scores[j][keep, None].numpy(),
                               res.classes[j][keep, None].numpy()], 1)
        np.testing.assert_allclose(port, ref[j], rtol=0, atol=1e-5)


def test_train_step_matches_the_port_in_float32():
    from pqdet_tpu_torch.config import Config
    from pqdet_tpu_torch.model.network import DetectionNetwork
    from pqdet_tpu_torch.ops.labels import label_assigner_from_config
    from pqdet_tpu_torch.train.step import make_loss_fn, value_and_grad
    from benchmark.train import make_pool
    spec = harness.load_spec()
    t = harness.load_cell(spec, 'mnv2-train-bf16-b32')['traffic']
    t = {**t, 'batch': 4, 'size': 128, 'pool': 1}
    text, lays, params, state, _ = setup('mnv2', 2.0)
    batch = make_pool(t, 20, torch.Generator().manual_seed(5), 'cpu')[0]
    cfg = Config()
    cfg.model.anchors = t['anchors']
    labels = label_assigner_from_config(cfg, device='cpu')
    grids, lists = RT.labels(batch['gt'], 128, t['strides'], t['anchors'], 20)
    port_t = labels(batch['gt'], (128, 128))
    for k in range(3):
        assert torch.equal(port_t[3 + k], lists[k])
        assert (port_t[k] - grids[k]).abs().max() < 1e-6
    net = DetectionNetwork.from_cfg(text)
    (loss, _), _ = value_and_grad(make_loss_fn(net, label_fn=labels), params, state, batch)
    ref, _, _ = RT.loss_and_grads(lays, params, state, batch['image'], batch['gt'],
                                  {'strides': t['strides'], 'anchors': t['anchors'],
                                   'classes': 20})
    assert abs(float(loss) - float(ref)) <= 1e-4 * abs(float(ref))
