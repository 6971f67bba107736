"""The port's spans and counters (``pqdet_tpu_torch/utils/tracing.py``) on
the CPU: recorded only under ``torch.profiler``, nested with their parent
and root, stamped on the clock of the profiler's host events; the spans
of the predict pipeline, of the int8 walk and of the train step; the
Chrome trace of ``utils/profiling.py::trace``; and the benchmark's
readers of them (``benchmark/metrics/``) on synthetic records.
"""

import json
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import pqdet_tpu_torch.utils as utils_pkg
from benchmark import harness
from pqdet_tpu_torch.compress.qat import QuantCtx, prepare_qat_state
from pqdet_tpu_torch.compress.quantized import Int8Inference, convert_to_int8
from pqdet_tpu_torch.config import Config
from pqdet_tpu_torch.evaluation.predict import build_predict_pipeline, make_batch_predict
from pqdet_tpu_torch.model.factory import build_detector
from pqdet_tpu_torch.model.network import DetectionNetwork
from pqdet_tpu_torch.ops.preprocess import device_normalize
from pqdet_tpu_torch.train.step import train_step_from_config
from pqdet_tpu_torch.utils import tracing
from pqdet_tpu_torch.utils.profiling import trace
from pqdet_tpu_torch.zoo import get_cfg

SIZE, B = 64, 2
PREDICT = ['predict.request', 'predict.upload', 'predict.normalize', 'predict.forward',
           'predict.recover', 'predict.nms', 'predict.copy_home', 'predict.to_numpy']
STEP = ['step', 'step.inputs', 'step.forward', 'step.backward', 'step.update']


@pytest.fixture(scope='module', autouse=True)
def one_torch_thread():
    """One intra-op thread for this module's small CPU ops, beside the
    suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_buffer():
    tracing.clear()
    yield
    tracing.clear()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def names(recs):
    return [s[0] for s in recs['spans']]


@pytest.fixture(scope='module')
def model():
    text = get_cfg('mobilenetv2-fpn', width_mult=0.25)
    net, params, state, _ = build_detector(text, device='cpu')
    return text, net, params, state


def images(seed, n=B):
    return np.random.RandomState(seed).randint(0, 256, (n, SIZE, SIZE, 3)).astype(np.uint8)


# ------------------------------------------------------------------ recorder

def test_nothing_is_recorded_without_a_profiler():
    with tracing.span('predict.request'):
        with tracing.span('predict.nms'):
            tracing.count('nms.rounds', 3)
    assert tracing.records() == {'spans': [], 'counters': {}}
    assert tracing.span('a') is tracing.span('b')       # the shared null context


def test_spans_nest_with_their_parent_and_root():
    with cpu_profile():
        for _ in range(2):
            with tracing.span('root'):
                with tracing.span('a'):
                    with tracing.span('a.inner'):
                        pass
                with tracing.span('b'):
                    tracing.count('c', 2)
        tracing.count('c', 5)                           # no span open: not counted
    r = tracing.records()
    assert names(r) == ['root', 'a', 'a.inner', 'b'] * 2
    assert [s[3] for s in r['spans']] == [None, 0, 1, 0, None, 4, 5, 4]
    assert [s[4] for s in r['spans']] == [0] * 4 + [4] * 4
    for name, start, end, parent, _ in r['spans']:
        assert start <= end
        if parent is not None:
            assert r['spans'][parent][1] <= start and end <= r['spans'][parent][2]
    assert r['counters'] == {'c': 4}


def test_a_new_session_clears_and_records_reads_without_clearing():
    with cpu_profile():
        with tracing.span('first'):
            pass
    assert names(tracing.records()) == ['first']
    assert names(tracing.records()) == ['first']
    with tracing.span('off'):                           # between sessions: nothing
        pass
    with cpu_profile():
        with tracing.span('second'):
            pass
    assert names(tracing.records()) == ['second']


def test_the_count_only_rises():
    seen = []
    with cpu_profile():
        for k in range(5):
            with tracing.span('root'):
                tracing.count('n', k)
            seen.append(tracing.records()['counters']['n'])
    assert seen == sorted(seen) and seen[-1] == sum(range(5))


def test_the_buffer_is_capped_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, 'CAP', 3)
    with cpu_profile():
        for _ in range(5):
            with tracing.span('root'):
                pass
    r = tracing.records()
    assert len(r['spans']) == 3 and r['counters']['tracing.dropped'] == 2


def test_spans_share_the_clock_of_the_profilers_host_events():
    """A span opened inside a ``record_function`` lies within that event's
    range, a ``record_function`` inside a span within the span, and so does
    each op dispatched inside a span (what the readers join by): the spans
    and the profiler's events are on one clock."""
    with cpu_profile() as prof:
        for k in range(6):
            with tracing.span('outer'):
                with record_function(f'inside{k}'):
                    torch.ones(4).add_(1)
            with record_function(f'around{k}'):
                with tracing.span('inner'):
                    torch.ones(4).mul_(2)
    events = list(prof.profiler.kineto_results.events())
    ev = {e.name(): (e.start_ns(), e.start_ns() + e.duration_ns()) for e in events}
    spans = tracing.records()['spans']
    outer = [s for s in spans if s[0] == 'outer']
    inner = [s for s in spans if s[0] == 'inner']
    muls = sorted(e.start_ns() for e in events if e.name() == 'aten::mul_')
    mul_ends = sorted(e.start_ns() + e.duration_ns() for e in events if e.name() == 'aten::mul_')
    assert len(muls) == 6
    for k in range(6):
        s0, s1 = ev[f'inside{k}']
        assert outer[k][1] <= s0 and s1 <= outer[k][2]
        r0, r1 = ev[f'around{k}']
        assert r0 <= inner[k][1] and inner[k][2] <= r1
        assert inner[k][1] <= muls[k] and mul_ends[k] <= inner[k][2]
    # nothing of the recorder enters the profiler's events
    assert not {'outer', 'inner'} & set(ev)


def test_innermost_open_span():
    spans = [('r', 0, 100, None, 0), ('a', 10, 40, 0, 0), ('a.i', 20, 30, 1, 0),
             ('b', 50, 90, 0, 0), ('open', 95, None, 0, 0), ('r2', 200, 300, None, 5)]
    assert tracing.innermost(spans, [-5, 0, 15, 25, 35, 45, 60, 99, 150, 250, 400]) == \
        [-1, 0, 1, 2, 1, 0, 3, 0, -1, 5, -1]


def test_trace_writes_the_spans_on_a_row_of_their_own(tmp_path):
    with trace(str(tmp_path)):
        with tracing.span('root'):
            with tracing.span('add'):
                torch.ones(8).add_(1)
            tracing.count('k', 2)
    doc = json.loads((tmp_path / 'trace.json').read_text())
    mine = [e for e in doc['traceEvents'] if e.get('cat') == 'program']
    assert [e['name'] for e in mine] == ['root', 'add']
    row = {e['pid'] for e in mine}
    assert len(row) == 1 and not row & {e.get('pid') for e in doc['traceEvents']
                                        if e.get('cat') != 'program' and e.get('ph') != 'M'}
    add = next(e for e in doc['traceEvents'] if e.get('name') == 'aten::add_')
    span = mine[1]
    assert span['ts'] <= add['ts'] and add['ts'] + add['dur'] <= span['ts'] + span['dur']
    assert doc['programCounters'] == {'k': 2}


# ------------------------------------------------------------- the program

def test_predict_spans_in_order_and_its_counters(model):
    text, net, params, state = model
    cfg = Config()
    cfg.eval.input_size = SIZE
    cfg.eval.score_threshold = 0.0
    cfg.eval.max_detections = 4
    cfg.eval.pool_factor = 1
    from pqdet_tpu_torch.model.factory import inference_params
    fused = inference_params(net, params, state)
    run = build_predict_pipeline(net, cfg, device='cpu')
    predict = make_batch_predict(run, fused)
    batches = [{'image': images(s), 'shape': np.array([[300, 400], [SIZE, SIZE]]), 'count': c}
               for s, c in ((0, 2), (1, 1))]
    with cpu_profile() as prof:
        dets = [predict(b) for b in batches]
    r = tracing.records()
    assert names(r) == PREDICT * 2
    roots = [i for i, s in enumerate(r['spans']) if s[3] is None]
    assert roots == [0, 8]
    assert all(s[3] == s[4] and s[4] in roots for s in r['spans'] if s[3] is not None)
    # the counters are make_batch_predict's own numbers
    over = sat = 0
    for b in batches:
        res = run(fused, b['image'], b['shape'])
        over += int(res.overflow[:b['count']].sum())
        sat += int((res.valid[:b['count']].sum(dim=1) == 4).sum())
    c = r['counters']
    assert c['predict.images'] == 3 == sum(len(d) for d in dets)
    assert c['predict.overflow_images'] == over > 0
    assert c['predict.saturated_images'] == sat == sum(len(x) == 4 for d in dets for x in d)
    assert 2 <= c['nms.rounds'] <= 2 * 4
    program = set(PREDICT)
    assert not program & {e.name() for e in prof.profiler.kineto_results.events()}


def test_int8_walk_spans(model):
    text, _, params, state = model
    qnet = DetectionNetwork.from_cfg(text, quant=True)
    qp, qs = prepare_qat_state(qnet, params, state)
    x = device_normalize(torch.from_numpy(images(2)))
    with torch.inference_mode():
        ctx = QuantCtx(qs['quant'], observing=True)
        qnet(qp, qs, x, quant_ctx=ctx)
        qparams = convert_to_int8(qnet, qp, {**qs, 'quant': ctx.new_obs})
    staged = Int8Inference.prepare(qparams, mode='kernel', network=qnet)
    inf = Int8Inference(qnet, mode='kernel')
    out_off = inf.apply(staged, x, plain=True)
    with cpu_profile():
        with tracing.span('predict.forward'):
            out_on = inf.apply(staged, x, plain=True)
    assert torch.equal(out_off, out_on)
    r = tracing.records()
    got = names(r)
    assert got[0] == 'predict.forward' and got[1] == 'int8.sandwich'     # the input's quant
    assert got.count('int8.im2col') >= 1 and got.count('int8.decode') >= 1
    convs = sum(n.kind == 'convolutional' for n in qnet.graph.nodes)
    assert got.count('int8.kernel') == convs
    sandwiches = sum(n.kind in ('shortcut', 'route') for n in qnet.graph.nodes)
    assert got.count('int8.sandwich') >= sandwiches + 1
    # one level under the root, but a 3x3's patches and kernel, which nest
    # in its int8.conv3x3
    conv3x3 = {i for i, s in enumerate(r['spans']) if s[0] == 'int8.conv3x3'}
    assert conv3x3 and all(s[4] == 0 for s in r['spans'][1:])
    assert all(s[3] == 0 or (s[3] in conv3x3 and s[0] in ('int8.im2col', 'int8.kernel'))
               for s in r['spans'][1:])
    assert all(r['spans'][i][3] == 0 for i in conv3x3)


def test_train_step_spans(model):
    text, _, params, state = model
    net = DetectionNetwork.from_cfg(text)
    cfg = Config()
    cfg.train.batch_size = B
    cfg.train.input_sizes = [SIZE]
    cfg.model.max_gt_boxes = 4
    step, opt = train_step_from_config(net, cfg, steps_per_epoch=4, device='cpu')
    gt = torch.zeros(B, 4, 6)
    gt[:, 0] = torch.tensor([8., 8., 40., 40., 3., 1.])
    batch = {'image': torch.from_numpy(images(3)), 'gt': gt}
    opt_state = opt.init(params)
    with cpu_profile():
        step(params, state, opt_state, batch)
    r = tracing.records()
    assert names(r) == STEP
    assert [s[3] for s in r['spans']] == [None, 0, 0, 0, 0]
    starts = [s[1] for s in r['spans'][1:]]
    assert starts == sorted(starts)


# ------------------------------------------------------------- the readers

def serve_rec():
    """One request at ns 100-900 in a 1000 ns window, with every predict
    stage, an im2col and a sandwich inside the forward, and the device's
    copies and kernels launched inside them."""
    spans = [('predict.request', 100, 900, None, 0), ('predict.upload', 110, 200, 0, 0),
             ('predict.normalize', 200, 250, 0, 0), ('predict.forward', 250, 400, 0, 0),
             ('int8.im2col', 260, 280, 3, 0), ('int8.sandwich', 300, 320, 3, 0),
             ('predict.recover', 400, 450, 0, 0), ('predict.nms', 450, 600, 0, 0),
             ('predict.copy_home', 600, 700, 0, 0), ('predict.to_numpy', 700, 890, 0, 0)]
    device = [('Memcpy HtoD', 120, 190, 120), ('im2col', 270, 290, 265),
              ('requant', 310, 330, 305), ('nms', 470, 500, 460), ('nms', 520, 560, 510),
              ('Memcpy DtoH', 610, 640, 605)]
    return ({'spans': spans, 'counters': {'nms.rounds': 6}},
            {'window': (0, 1000), 'spans': {}, 'device': device, 'launches': [], 'n': 1})


def train_rec():
    spans = [('step', 100, 900, None, 0), ('step.inputs', 110, 200, 0, 0),
             ('step.forward', 200, 500, 0, 0), ('step.backward', 500, 800, 0, 0),
             ('step.update', 800, 890, 0, 0)]
    device = [('bn', 150, 180, 140), ('adam', 850, 870, 840)]
    return ({'spans': spans, 'counters': {}},
            {'window': (0, 1000), 'spans': {}, 'device': device, 'launches': [], 'n': 1})


# gaps of serve_rec: 0-120 outside every span, 190-270 upload, 290-310 and
# 330-470 forward, 500-520 and 560-610 nms, 640-1000 copy_home
READINGS = {
    'serve.upload_device_ms': (serve_rec, 70e-6),
    'serve.int8_im2col_device_ms': (serve_rec, 20e-6),
    'serve.int8_sandwich_device_ms': (serve_rec, 20e-6),
    'serve.nms_rounds': (serve_rec, 6.0),
    'serve.nms_idle_ms': (serve_rec, 70e-6),
    'serve.tail_idle_ms': (serve_rec, 360e-6),
    'serve.idle_outside_spans_share': (serve_rec, 100.0 * 120 / 790),
    'train.inputs_host_ms': (train_rec, 90e-6),
    'train.forward_host_ms': (train_rec, 300e-6),
    'train.backward_host_ms': (train_rec, 300e-6),
    'train.update_host_ms': (train_rec, 90e-6),
    'train.idle_outside_spans_share': (train_rec, 100.0 * 150 / 950),
}


@pytest.mark.parametrize('name', sorted(READINGS))
def test_reader_on_a_synthetic_record(name, monkeypatch):
    make, want = READINGS[name]
    recs, rec = make()
    monkeypatch.setattr(tracing, 'records', lambda: recs)
    assert harness.load_reader(name)(rec) == pytest.approx(want)


@pytest.mark.parametrize('name', sorted(READINGS))
def test_reader_finds_nothing_without_spans(name, monkeypatch):
    _, rec = READINGS[name][0]()
    read = harness.load_reader(name)
    monkeypatch.setattr(tracing, 'records', lambda: {'spans': [], 'counters': {}})
    assert read(rec) is None
    # a program without the recorder, as before it had one
    monkeypatch.delattr(utils_pkg, 'tracing')
    monkeypatch.setitem(sys.modules, 'pqdet_tpu_torch.utils.tracing', None)
    assert read(rec) is None


def test_every_new_reader_has_its_entry():
    spec = harness.load_spec()
    entries = {m['name']: m for m in spec['per_layer']}
    for name in READINGS:
        m = entries[name]
        assert m['workloads'] and m['source'] in ('device_trace', 'program_counter')
        assert m['moves'] == ('train_images_per_s' if name.startswith('train.')
                              else 'serve_images_per_s')
