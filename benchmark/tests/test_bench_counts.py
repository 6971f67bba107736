"""The frozen operation and byte counts against numbers worked by hand, and
the shapes the yardstick reads from a cfg against the port's own graph."""

import pytest
import torch

from benchmark import counts, harness, weights
from benchmark.reference.cfg import layers, out_sides

MNV2 = harness.ROOT / 'benchmark' / 'configs' / 'mobilenetv2-fpn.cfg'
RX600 = harness.ROOT / 'benchmark' / 'configs' / 'regnetx-600m-fpn.cfg'


def test_first_fused_chain_by_hand():
    lays = layers(MNV2.read_text())
    chain = counts.fused_chains(lays)[0]
    assert chain == (6, 7, 8)           # 24 -> 144 -> dw 3x3 -> 24 at stride 4
    sides = out_sides(lays, 512)
    ops = sum(counts.conv_ops(lays[i], sides[i]) for i in chain)
    assert ops == 2 * (24 * 144 + 9 * 144 + 144 * 24) * 128 * 128 == 268_959_744
    # B=1: bf16 input and output maps, bf16 weights, f32 biases
    nbytes = 128 * 128 * 24 * 2 * 2 + (3456 + 1296 + 3456) * 2 + (144 + 144 + 24) * 4
    assert nbytes == 1_590_528
    want = max(nbytes / 3.35e12, ops / 989e12)
    assert counts.fused_chain_bound_s(lays, chain, 512, 1) == pytest.approx(want, rel=1e-12)


def test_grouped_conv_by_hand():
    lays = layers(RX600.read_text())
    g = lays[4]                          # 48 -> 48, 3x3, stride 2, 2 groups of 24
    assert (g['cin'], g['cout'], g['groups'], g['stride']) == (48, 48, 2, 2)
    assert counts.conv_ops(g, 128) == 2 * 9 * 24 * 48 * 128 * 128 == 339_738_624
    only = [l if l['index'] == 4 else {**l, 'kind': 'x'} for l in lays]
    nbytes = 256 * 256 * 48 + 9 * 24 * 48 + 12 * 48 + 128 * 128 * 48
    assert nbytes == 3_943_104
    want = max(nbytes / 3.35e12, 339_738_624 / 1979e12)
    assert counts.qconv1x1_bound_s(only, 512, 1) == pytest.approx(want, rel=1e-12)


def test_forward_ops_of_both_configurations():
    assert counts.forward_ops(layers(MNV2.read_text()), 512) == 8_302_821_376
    assert counts.forward_ops(layers(RX600.read_text()), 512) == 8_557_543_424


@pytest.mark.parametrize('path', [MNV2, RX600])
def test_yardstick_shapes_match_the_port(path):
    from pqdet_tpu_torch.model.network import DetectionNetwork
    from pqdet_tpu_torch.ops.fused_ir import find_fused_triples
    text = path.read_text()
    lays = layers(text)
    net = DetectionNetwork.from_cfg(text)
    assert [n.kind for n in net.graph.nodes] == [l['kind'] for l in lays]
    assert [n.out_channels for n in net.graph.nodes] == [l['cout'] for l in lays]
    assert find_fused_triples(net.graph) == counts.fused_chains(lays)
    params, state = weights.make(lays, torch.Generator().manual_seed(0), 2.0, 'cpu')
    ref_p, ref_s = net.init(torch.Generator().manual_seed(0), device='cpu')

    def shape(t):
        return {k: shape(v) for k, v in t.items()} if isinstance(t, dict) else t.shape
    assert shape(params) == shape(ref_p) and shape(state) == shape(ref_s)
