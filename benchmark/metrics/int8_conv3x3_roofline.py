"""% of their roofline that the int8 walk's 3x3 convs reach, patches and
GEMM together: the least time of the cfg's non-depthwise 3x3 convs at the
traffic's size and batch (each conv's own work, 2 * 9 * (Cin / groups) *
Cout * Ho * Wo operations at the int8 peak, against its bytes: s8 input
read once, weights once, 12 bytes a channel of scales and bias, output
written once, int8 on a requantised edge and f32 on a head's) over the
device time of the kernels that the host launched inside the program's
``int8.conv3x3`` spans (``compress/quantized.py``), one span a conv of a
forward. It reads the same work whatever computes it. None where the
program records no such spans."""

from benchmark import counts
from benchmark.reference.cfg import out_sides
from benchmark.trace import in_spans


def conv3x3_layers(lays):
    """The cfg's 3x3 convs that are not depthwise."""
    return [l for l in lays if l['kind'] == 'convolutional' and l['size'] == 3
            and l['cin'] // l['groups'] > 1]


def conv3x3_bound_s(lays, size: int, batch: int) -> float:
    """Least time of one forward's non-depthwise 3x3 convs at ``batch``
    images of ``size``, summed over the convs."""
    sides = out_sides(lays, size)
    feeders = {l['index'] - 1 for l in lays if l['kind'] == 'yolo'}
    total = 0.0
    for l in conv3x3_layers(lays):
        i = l['index']
        side_in = size // (l['stride_total'] // l['stride'])
        nbytes = (batch * side_in ** 2 * l['cin'] + counts.conv_weights(l) + 12 * l['cout']
                  + batch * sides[i] ** 2 * l['cout'] * (4 if i in feeders else 1))
        total += max(nbytes / counts.HBM_BYTES_PER_S,
                     batch * counts.conv_ops(l, sides[i]) / counts.INT8_OP_PER_S)
    return total


def read(rec):
    try:
        from pqdet_tpu_torch.utils import tracing
    except ImportError:
        return None
    w0, w1 = rec['window']
    spans = [s for s in tracing.records()['spans'] if s[2] is not None and w0 <= s[1] <= w1]
    inside = sorted((s, e) for n, s, e, _, _ in spans if n == 'int8.conv3x3')
    per = len(conv3x3_layers(rec['layers']))
    if not inside or not per:
        return None
    starts = [s for s, _ in inside]
    t = sum(e - s for _, s, e, at in rec['device'] if in_spans(at, inside, starts) >= 0)
    if t <= 0:
        return None
    tr = rec['traffic']
    return 100.0 * conv3x3_bound_s(rec['layers'], tr['size'], tr['batch']) * len(inside) \
        / per / (t / 1e9)
