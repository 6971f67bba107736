"""Operation and byte counts from a cfg's shapes, and the H100's peaks.

A conv needs 2 * k^2 * (cin / groups) * cout * Ho * Wo operations a
image: the work of the cfg's layer, whatever computes it, so a grouped
conv run densified still counts its grouped work. A roofline counts each
input byte read once and each output byte written once, and takes the
larger of bytes / HBM bandwidth and operations / peak as the least time.

Peaks: NVIDIA's data sheet for the H100 SXM, dense: 989 TFLOP/s bf16,
1,979 TOP/s int8, 3.35 TB/s HBM3.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .reference.cfg import out_sides

BF16_FLOP_PER_S = 989e12
INT8_OP_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12
PEAK = {'bf16': BF16_FLOP_PER_S, 'int8': INT8_OP_PER_S}

FUSABLE_ACTS = ('relu6', 'relu', 'leaky', 'linear', 'logistic')
LANE = 128


def conv_ops(lay: Dict, side_out: int) -> int:
    """Operations of one conv layer for one image."""
    k = lay['size']
    return 2 * k * k * (lay['cin'] // lay['groups']) * lay['cout'] * side_out * side_out


def conv_weights(lay: Dict) -> int:
    return lay['size'] ** 2 * (lay['cin'] // lay['groups']) * lay['cout']


def forward_ops(lays: List[Dict], size: int) -> int:
    """Operations of all conv layers for one image at a square input."""
    sides = out_sides(lays, size)
    return sum(conv_ops(l, sides[l['index']]) for l in lays if l['kind'] == 'convolutional')


def _consumers(lays) -> Dict[int, List[int]]:
    out = {l['index']: [] for l in lays}
    for l in lays:
        if l['index'] > 0 and l['kind'] != 'route':
            out[l['index'] - 1].append(l['index'])
        for r in l.get('refs', ()):
            out[r].append(l['index'])
    return out


def fused_chains(lays: List[Dict]) -> List[Tuple]:
    """The [1x1] -> [depthwise 3x3, stride 1] -> [1x1] chains whose inner
    outputs feed only the next layer, then the bare [dw 3x3] -> [1x1] pairs
    whose depthwise width is a whole number of 128-channel tiles: the
    chains a fused inverted-residual kernel runs as one launch."""
    cons = _consumers(lays)

    def pw(l):
        return (l['kind'] == 'convolutional' and l['size'] == 1 and l['stride'] == 1
                and l['groups'] == 1 and l['pad'] == 0 and l['act'] in FUSABLE_ACTS)

    def dw(l):
        return (l['kind'] == 'convolutional' and l['size'] == 3 and l['stride'] == 1
                and l['groups'] == l['cin'] == l['cout'] and l['pad'] == 1
                and l['act'] in FUSABLE_ACTS)

    def only_next(l):
        return cons[l['index']] == [l['index'] + 1]
    out, used = [], set()
    for i in range(len(lays) - 2):
        a, b, c = lays[i:i + 3]
        if i in used or not (pw(a) and dw(b) and pw(c) and only_next(a) and only_next(b)):
            continue
        out.append((i, i + 1, i + 2))
        used.update((i, i + 1, i + 2))
    for i in range(len(lays) - 1):
        b, c = lays[i:i + 2]
        if i in used or i + 1 in used or not (dw(b) and pw(c) and only_next(b)):
            continue
        if b['cin'] % LANE:
            continue
        out.append((None, i, i + 1))
        used.update((i, i + 1))
    return out


def fused_chain_bound_s(lays: List[Dict], chain, size: int, batch: int) -> float:
    """Least time of one chain at ``batch`` images: bf16 activations and
    weights, f32 biases."""
    sides = out_sides(lays, size)
    a, b, c = chain
    first = lays[a if a is not None else b]
    side_in = size // (first['stride_total'] // first['stride'])
    ops = sum(conv_ops(lays[i], sides[i]) for i in chain if i is not None) * batch
    weights = sum(conv_weights(lays[i]) for i in chain if i is not None)
    biases = sum(lays[i]['cout'] for i in chain if i is not None)
    nbytes = (batch * side_in ** 2 * first['cin'] * 2 + batch * sides[c] ** 2 * lays[c]['cout'] * 2
              + weights * 2 + biases * 4)
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOP_PER_S)


def qconv1x1_convs(lays: List[Dict]) -> List[Dict]:
    """The convs an int8 forward routes to the 1x1 int8 kernel: every conv
    but the depthwise 3x3s (the 1x1s, strided 1x1s, the dense stem and the
    grouped 3x3s, the last two as im2col patches)."""
    return [l for l in lays if l['kind'] == 'convolutional'
            and not (l['size'] == 3 and l['cin'] // l['groups'] == 1)]


def qconv1x1_bound_s(lays: List[Dict], size: int, batch: int) -> float:
    """Least time of the convs routed to the 1x1 int8 kernel, summed over
    the convs, for one forward at ``batch`` images: int8 input and weights,
    int8 output on a requantised edge and f32 on a head's, 12 bytes a
    channel of scales and bias."""
    sides = out_sides(lays, size)
    feeders = {l['index'] - 1 for l in lays if l['kind'] == 'yolo'}
    total = 0.0
    for l in qconv1x1_convs(lays):
        i = l['index']
        side_in = size // (l['stride_total'] // l['stride'])
        out_b = 4 if i in feeders else 1
        nbytes = (batch * side_in ** 2 * l['cin'] + conv_weights(l) + 12 * l['cout']
                  + batch * sides[i] ** 2 * l['cout'] * out_b)
        total += max(nbytes / HBM_BYTES_PER_S, batch * conv_ops(l, sides[i]) / INT8_OP_PER_S)
    return total
