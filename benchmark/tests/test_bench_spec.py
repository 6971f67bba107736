"""BENCHMARK.json against the contract's shape, and the harness finding every
part of a cell by name."""

import json
import re
import shutil

import pytest

from benchmark import harness

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
SPEC = harness.load_spec()


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                         'end_to_end', 'per_layer'}
    assert 1 <= SPEC['run_seconds'] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    assert SPEC['paths'] == ['benchmark']
    assert all(not w.startswith('/') and '..' not in w for w in SPEC['command'])


@pytest.mark.parametrize('group', ['configs', 'workloads', 'end_to_end', 'per_layer'])
def test_names_units_and_keys(group):
    names = [e['name'] for e in SPEC[group]]
    assert len(set(names)) == len(names)
    for e in SPEC[group]:
        assert NAME.match(e['name']), e['name']
        if 'unit' in e:
            assert UNIT.match(e['unit']), e['unit']
            assert e['better'] in ('lower', 'higher')
        for k in ('why', 'layer', 'source'):
            if k in e and group != 'end_to_end' and k != 'source':
                assert 1 <= len(e[k]) <= 200 and '\n' not in e[k] and '\t' not in e[k]


def test_metrics_bounds_and_moves():
    e2e = {m['name'] for m in SPEC['end_to_end']}
    assert 'setup_s' in e2e
    for m in SPEC['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25 and m['source'] in ('host_clock', 'device_trace')
    for m in SPEC['per_layer']:
        assert m['moves'] in e2e and 'bound' not in m
    cells = {w['name'] for w in SPEC['workloads']}
    for m in SPEC['end_to_end'] + SPEC['per_layer']:
        assert set(m.get('workloads', cells)) <= cells


@pytest.mark.parametrize('workload', [w['name'] for w in SPEC['workloads']])
def test_every_cell_finds_its_files(workload):
    cell = harness.load_cell(SPEC, workload)
    assert cell['traffic']['kind'] in ('serve', 'train')
    assert cell['cfg_text'].startswith('[net]')
    assert cell['workload']['chips'] == 1
    e2e = harness.cell_metrics(SPEC, workload, 'end_to_end')
    assert 'setup_s' in {m['name'] for m in e2e} and len(e2e) >= 2
    layer = harness.cell_metrics(SPEC, workload, 'per_layer')
    assert layer
    for m in layer:
        assert callable(harness.load_reader(m['name']))
        assert m['moves'] in {x['name'] for x in e2e}


def trace_record(device=()):
    """A traced record as ``trace.reduce_events`` makes it: a 1 s window."""
    return {'window': (0, 10 ** 9), 'spans': {}, 'device': list(device), 'launches': []}


def test_a_new_metric_is_picked_up_from_files_alone(tmp_path):
    """A per-layer metric added as a new reader file and a new entry, in a
    copy of the benchmark, is found and read with no other file edited;
    the reader works out a bound from the cell's shapes, as a kernel's
    roofline does."""
    root = tmp_path / 'ckout'
    shutil.copytree(harness.ROOT / 'benchmark', root / 'benchmark',
                    ignore=shutil.ignore_patterns('.cache', '__pycache__'))
    spec = json.loads(json.dumps(SPEC))
    cell = spec['workloads'][0]['name']
    spec['per_layer'].append({'name': 'dummy.conv_roofline', 'unit': '%', 'better': 'higher',
                              'source': 'device_trace', 'layer': 'kernel dummy',
                              'moves': 'serve_images_per_s', 'workloads': [cell]})
    (root / 'BENCHMARK.json').write_text(json.dumps(spec))
    (root / 'benchmark' / 'metrics' / 'dummy.conv_roofline.py').write_text(
        'from benchmark import counts\n\n\n'
        'def read(rec):\n'
        '    ks = [e - s for name, s, e, _ in rec["device"] if name == "dummy_conv"]\n'
        '    t = rec["traffic"]\n'
        '    if not ks:\n'
        '        return None\n'
        '    ops = counts.forward_ops(rec["layers"], t["size"]) * t["batch"] * len(ks)\n'
        '    return 100.0 * ops / counts.PEAK[t["precision"]] / (sum(ks) / 1e9)\n')
    got = harness.load_spec(root)
    c = harness.load_cell(got, cell, root)
    names = [m['name'] for m in harness.cell_metrics(got, cell, 'per_layer')]
    assert 'dummy.conv_roofline' in names
    counters = {'images': 80, 'saturated_images': 0, 'overflow_images': 0}
    rec = harness.cell_record(trace_record([('dummy_conv', 0, 5 * 10 ** 6, 0)]), c,
                              {'requests': 1, 'images': 80}, counters,
                              {'images': 80, 'wall_s': 1.0})
    out = harness.per_layer_metrics(got, cell, rec, root)
    want = 100.0 * 8_302_821_376 * 80 / 989e12 / 5e-3
    assert out['dummy.conv_roofline'] == {'value': pytest.approx(want, rel=1e-12), 'unit': '%'}


@pytest.mark.parametrize('workload', [w['name'] for w in SPEC['workloads']])
def test_every_reader_reads_an_empty_trace_as_nothing(workload):
    """A traced window in which nothing ran on the device: every reader
    that needs the device finds nothing and returns None, not 0."""
    cell = harness.load_cell(SPEC, workload)
    rec = harness.cell_record(trace_record(), cell, {'requests': 1, 'steps': 1, 'images': 1},
                              {}, {'images': 1, 'wall_s': 1.0})
    assert harness.per_layer_metrics(SPEC, workload, rec) == {}


def test_rooflines_read_their_bound_from_the_cell():
    """The fused-IR roofline of one forward's chains, each run in exactly
    its least time, reads 100 %."""
    from benchmark import counts
    from benchmark.reference.cfg import layers
    cell = harness.load_cell(SPEC, 'mnv2-serve-bf16-b80')
    t, lays = cell['traffic'], layers(cell['cfg_text'])
    dev, at = [], 0
    for ch in counts.fused_chains(lays):
        ns = counts.fused_chain_bound_s(lays, ch, t['size'], t['batch']) * 1e9
        dev.append(('fused_ir_kernel', at, at + ns, None))
        at += ns
    rec = harness.cell_record(trace_record(dev), cell, {'requests': 1, 'images': 80}, {}, None)
    got = harness.load_reader('fused_ir_conv_roofline')(rec)
    assert got == pytest.approx(100.0, rel=1e-9)
