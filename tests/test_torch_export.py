"""The port's ``torch.export`` artifacts (``pqdet_tpu_torch/exporters/
export.py``) on the CPU: the fp program with and without NMS against the
port's eager plain forward (exactly) and JAX's ``export_stablehlo`` round
trip (1e-4), the exported NMS fixed point against eager ``nms_batch`` on
long suppression chains (bit for bit), the int8 programs against
``Int8Inference`` in their modes (on the CPU the registered operators run
the plain versions), an artifact loaded in a fresh process, and which
operators each graph holds.
"""

import collections
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch import nn

from pqdet_tpu.exporters.export import export_stablehlo as jax_export_stablehlo
from pqdet_tpu.exporters.export import load_stablehlo as jax_load_stablehlo
from pqdet_tpu.model.network import DetectionNetwork as JaxNetwork
from pqdet_tpu.model.network import fuse_params as jax_fuse_params
from pqdet_tpu_torch.bridge import from_jax_params
from pqdet_tpu_torch.compress.qat import QuantCtx, prepare_qat_state
from pqdet_tpu_torch.compress.quantized import Int8Inference, convert_to_int8
from pqdet_tpu_torch.exporters.export import (export_stablehlo, export_stablehlo_quant,
                                              load_stablehlo)
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.ops import decode_kernel, library, qconv
from pqdet_tpu_torch.ops.postprocess import nms_batch
from tests.test_prune import _mobile_style_cfg

REPO = Path(__file__).resolve().parent.parent
SIZE = 32
NMS_ARGS = (0.1, 0.45, 64)
KERNELS = ((qconv, 'qconv1x1_s8'), (qconv, 'qdwconv3x3_s8'), (decode_kernel, 'decode_heads'),
           (qconv, 'int8_sandwich'))


@pytest.fixture(scope='module')
def fp_model():
    """(JAX net, JAX fused params, port net, port fused params, input) of
    the mobile-style cfg at 32 px, the weights JAX's init."""
    cfg = _mobile_style_cfg()
    jnet = JaxNetwork.from_cfg(cfg)
    params, state = jnet.init(jax.random.PRNGKey(0))
    jfused = jax_fuse_params(jnet, params, state)
    net = DetectionNetwork.from_cfg(cfg)
    fused, _ = from_jax_params(jax.tree.map(np.asarray, jfused), {}, net.graph, device='cpu')
    x = np.random.RandomState(0).rand(2, SIZE, SIZE, 3).astype(np.float32)
    return jnet, jfused, net, fused, x


@pytest.fixture(scope='module')
def fp_artifacts(fp_model):
    """{with_nms: (blob, loaded program)}."""
    _, _, net, fused, _ = fp_model
    blobs = {nms: export_stablehlo(net, fused, (SIZE, SIZE), batch_size=2, with_nms=nms,
                                   score_threshold=NMS_ARGS[0], iou_threshold=NMS_ARGS[1],
                                   max_detections=NMS_ARGS[2], device='cpu')
             for nms in (False, True)}
    return {k: (b, load_stablehlo(b, device='cpu')) for k, b in blobs.items()}


@pytest.fixture(scope='module')
def int8_model():
    """(quant net, int8 qparams, input) of the mobile-style cfg at 32 px
    (its stem and dense 3x3s take the im2col route into the 1x1 kernel),
    calibrated by one observer pass of the port."""
    net = DetectionNetwork.from_cfg(_mobile_style_cfg(), quant=True)
    params, state = net.init(torch.Generator().manual_seed(0), device='cpu')
    params, state = prepare_qat_state(net, params, state)
    x = torch.from_numpy(np.random.RandomState(1).rand(2, SIZE, SIZE, 3).astype(np.float32))
    with torch.inference_mode():
        ctx = QuantCtx(state['quant'], observing=True)
        net(params, state, x, quant_ctx=ctx)
        qparams = convert_to_int8(net, params, {**state, 'quant': ctx.new_obs})
    return net, qparams, x


@pytest.fixture(scope='module')
def int8_artifacts(int8_model):
    """{mode: (blob, loaded program)}."""
    net, qparams, _ = int8_model
    blobs = {mode: export_stablehlo_quant(net, qparams, (SIZE, SIZE), batch_size=2, mode=mode,
                                          device='cpu')
             for mode in ('int', 'kernel')}
    return {k: (b, load_stablehlo(b, device='cpu')) for k, b in blobs.items()}


@pytest.fixture
def counted(monkeypatch):
    """The four kernel wrappers replaced by counting ones in their modules
    (and where the eager walks take them: ``model.network`` and the int8
    walk's ``library.WRAPPERS``): {name: calls}."""
    from pqdet_tpu_torch.model import network
    calls = {name: 0 for _, name in KERNELS}
    entries = {f.__name__: e for e, f in zip(library.Kernels._fields, library.WRAPPERS)}
    table = library.WRAPPERS
    for mod, name in KERNELS:
        def wrapper(*args, _f=getattr(mod, name), _name=name, **kw):
            calls[_name] += 1
            return _f(*args, **kw)
        for m in (mod, network):
            if hasattr(m, name):
                monkeypatch.setattr(m, name, wrapper)
        table = table._replace(**{entries[name]: wrapper})
    monkeypatch.setattr(library, 'WRAPPERS', table)
    return calls


def test_fp_artifact_equals_eager_and_jax(fp_model, fp_artifacts):
    jnet, jfused, net, fused, x = fp_model
    fn = fp_artifacts[False][1]
    with torch.inference_mode():
        ref = net(fused, {}, torch.from_numpy(x), plain=True)
        out = fn(torch.from_numpy(x))
    assert torch.equal(out, ref)
    jfn = jax_load_stablehlo(jax_export_stablehlo(jnet, jfused, input_size=(SIZE, SIZE),
                                                  batch_size=2))
    np.testing.assert_allclose(out.numpy(), np.asarray(jfn(jnp.asarray(x))),
                               rtol=1e-4, atol=1e-4)


def test_fp_nms_artifact_equals_eager(fp_model, fp_artifacts):
    _, _, net, fused, x = fp_model
    fn = fp_artifacts[True][1]
    with torch.inference_mode():
        ref = nms_batch(net(fused, {}, torch.from_numpy(x), plain=True), *NMS_ARGS)
        out = fn(torch.from_numpy(x))
    assert len(out) == 4
    for got, want in zip(out, ref[:4]):
        assert got.dtype == want.dtype and torch.equal(got, want)


class _Nms(nn.Module):
    def forward(self, boxes_scores):
        r = nms_batch(boxes_scores, 0.1, 0.45, 40)
        return r.boxes, r.scores, r.classes, r.valid, r.overflow


def _chains(n=48):
    """Three images of n boxes and 2 classes: a chain along x where each box
    overlaps its neighbour (IoU 7/13) and not the next but one (IoU 1/4),
    scores falling along it, so greedy NMS keeps every other box and the
    fixed point needs ~n/2 steps; the same chain in both classes with
    shuffled scores; and random boxes."""
    rng = np.random.RandomState(5)
    x0 = np.arange(n, dtype=np.float32) * 3.0
    chain = np.stack([x0, np.zeros(n), x0 + 10.0, np.full(n, 10.0)], -1).astype(np.float32)
    falling = np.linspace(0.95, 0.2, n).astype(np.float32)
    img0 = np.concatenate([chain, falling[:, None], np.zeros((n, 1), np.float32)], -1)
    img1 = np.concatenate([chain, rng.permutation(falling)[:, None],
                           falling[::-1, None]], -1)
    xy = rng.rand(n, 2).astype(np.float32) * 40
    wh = rng.rand(n, 2).astype(np.float32) * 20 + 2
    img2 = np.concatenate([xy, xy + wh, rng.rand(n, 2).astype(np.float32)], -1)
    return torch.from_numpy(np.stack([img0, img1, img2]))


def test_exported_nms_equals_eager_on_long_chains():
    bs = _chains()
    exported = torch.export.export(_Nms(), (bs,))
    ops = {str(n.target) for n in exported.graph.nodes if n.op == 'call_function'}
    assert any('while_loop' in o for o in ops)
    ref = _Nms()(bs)
    # greedy keeps every other box of the falling chain: a long fixed point
    kept = ref[0][0][ref[3][0]][:, 0]
    assert len(kept) == 24 and torch.equal(kept, torch.arange(0, 144, 6, dtype=torch.float32))
    out = exported.module()(bs)
    for got, want in zip(out, ref):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_int8_artifacts_equal_int8_inference(int8_model, int8_artifacts, counted):
    """``'int'`` equals ``Int8Inference(mode='int').apply(plain=True)`` and
    ``'kernel'`` equals ``Int8Inference(mode='kernel')``, bit for bit; the
    ``'kernel'`` program calls each kernel's wrapper (through its operator)
    as often as the eager kernel walk does, the ``'int'`` one none."""
    net, qparams, x = int8_model
    for mode, (_, fn) in int8_artifacts.items():
        inf = Int8Inference(net, mode=mode)
        with torch.inference_mode():
            ref = inf.apply(Int8Inference.prepare(qparams, mode), x, plain=mode == 'int')
            eager = dict(counted)
            out = fn(x)
        program = {k: counted[k] - eager[k] for k in counted}
        assert torch.equal(out, ref), mode
        if mode == 'kernel':
            assert program == eager and min(eager.values()) >= 1, (program, eager)
        else:
            assert set(program.values()) == {0}
        for k in counted:
            counted[k] = 0


def test_artifact_graph_ops(fp_artifacts, int8_artifacts):
    """The fp and ``'int'`` programs hold no operator of the port's
    namespace; ``'kernel'`` holds the five: six convs through the 1x1
    kernel (the stem as im2col patches, the five 1x1s with the head), the
    two dense 3x3s of Cin 48 through the dense 3x3 kernel, the depthwise
    conv, one decode, and three sandwiches (the input's quantisation, the
    shortcut, the route; the SE's scale keeps its chain)."""
    for _, fn in (*fp_artifacts.values(), int8_artifacts['int']):
        assert library.graph_ops(fn) == []
    ops = collections.Counter(library.graph_ops(int8_artifacts['kernel'][1]))
    assert ops == {'pqdet.qconv1x1_s8.default': 6, 'pqdet.qconv3x3_s8.default': 2,
                   'pqdet.qdwconv3x3_s8.default': 1, 'pqdet.decode_heads.default': 1,
                   'pqdet.int8_sandwich.default': 3}


def test_kernel_artifact_loads_in_a_fresh_process(int8_model, int8_artifacts, tmp_path):
    """A kernel artifact loaded by a fresh interpreter that imports only
    pqdet_tpu_torch gives what the same artifact loaded here gives."""
    _, _, x = int8_model
    art, inp, res = (tmp_path / 'k.pt2', tmp_path / 'x.npy', tmp_path / 'y.npy')
    art.write_bytes(int8_artifacts['kernel'][0])
    np.save(inp, x.numpy())
    code = textwrap.dedent(f"""
        import sys
        import numpy as np, torch
        from pqdet_tpu_torch.exporters.export import load_stablehlo
        fn = load_stablehlo(open({str(art)!r}, 'rb').read(), device='cpu')
        with torch.inference_mode():
            y = fn(torch.from_numpy(np.load({str(inp)!r})))
        np.save({str(res)!r}, y.numpy())
        bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'pqdet_tpu'))
        sys.exit(1 if bad else 0)
    """)
    run = subprocess.run([sys.executable, '-c', code], cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
    with torch.inference_mode():
        here = int8_artifacts['kernel'][1](x)
    np.testing.assert_array_equal(np.load(res), here.numpy())


def test_export_quant_rejects_unknown_mode(int8_model):
    net, qparams, _ = int8_model
    with pytest.raises(ValueError, match='mode'):
        export_stablehlo_quant(net, qparams, (SIZE, SIZE), mode='pallas', device='cpu')
