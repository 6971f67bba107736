"""Fused bf16 inverted-residual block: the CUDA kernel's wrapper, its plain
version, and the walk-time fusion table.

The port of ``pqdet_tpu/ops/pallas_fused.py``. The kernel
(``csrc/fused_ir.cu``) computes

    [1x1 expand + act_e] -> [dw 3x3 s1 p1 + act_dw] -> [1x1 project + act_p]

on NHWC bf16 in one launch, keeping the expanded activation out of device
memory; a bare dw3x3 + pw1x1 pair when there is no expand. Weights are in
the kernel's layout, unpadded: we (Cin, E) bf16, be (E,) f32, wdw (9, E)
bf16, bdw (E,) f32, wp (E, P) bf16, bp (P,) f32; the kernel masks ragged
E and P itself (the JAX package padded them to 128 lanes, a TPU layout
artifact).

``fused_ir_conv`` runs the kernel for a CUDA tensor and the plain
``fused_ir_reference`` for a CPU tensor; it raises on any other device.
``plan_fused_ir`` chooses the kernel's pixel tile, thread-block cluster,
K step, stages and projection form from the shapes, as plain ints for the
C entry point.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from pqdet_tpu_torch.model.graph import solve_padding
from pqdet_tpu_torch.ops import refuse_autograd

LANE = 128  # bare-pair rule of find_fused_triples: dw width a whole lane tile

ACT_CODES = {'linear': 0, 'none': 0, 'relu': 1, 'relu6': 2, 'leaky': 3,
             'logistic': 4}
_FUSABLE_ACTS = ('relu6', 'relu', 'leaky', 'linear', 'none', 'logistic')


def _apply_act(act: str, y):
    if act == 'leaky':
        return torch.where(y > 0, y, 0.1 * y)
    if act == 'relu':
        return torch.clamp_min(y, 0.0)
    if act == 'relu6':
        return torch.clamp(y, 0.0, 6.0)
    if act in ('linear', 'none'):
        return y
    if act == 'logistic':
        return torch.sigmoid(y)
    raise ValueError(f'unsupported activation for the fused kernel: {act}')


def _bf(t):
    """Round to bf16 and compute on in f32."""
    return t.to(torch.bfloat16).float()


def fused_ir_reference(x, we, be, wdw, bdw, wp, bp, *, act_e='relu6',
                       act_dw='relu6', act_p='linear'):
    """Plain version of the kernel: f32 arithmetic on bf16-rounded inputs
    and weights, with an explicit bf16 round at the three stage
    boundaries (exactly the bf16 discipline, also on the CPU where bf16
    depthwise convs are a weak spot). Same arguments as the kernel;
    returns (N, H, W, P) bf16."""
    y = _bf(x)
    if we is not None:
        y = _bf(_apply_act(act_e, y @ _bf(we) + be.float()))
    e = wdw.shape[1]
    k = _bf(wdw).t().reshape(e, 1, 3, 3)
    y = F.conv2d(y.permute(0, 3, 1, 2), k, None, 1, 1, 1, e).permute(0, 2, 3, 1)
    y = _bf(_apply_act(act_dw, y + bdw.float()))
    y = _apply_act(act_p, y @ _bf(wp) + bp.float())
    return y.to(torch.bfloat16)


SMEM_MAX = 232448      # dynamic shared memory one CTA may use on Hopper
SMEM_TWO = 115712      # ... and each of two CTAs on one SM (228 KB less 1 KB each)
MAX_CLUSTER = 8        # the portable thread-block cluster size
SMS = 132              # SMs of an H100 SXM
PROJECT_K = 64         # the kernel's K step over E in the projection (KP)
X_COPIES = 8 * 256     # 16-byte x-tile copies per K step, at most (MAXI * NT)


class FusedIrPlan(NamedTuple):
    """Launch plan of one fused chain, plain ints for the C entry point:
    a ``th`` x ``tw`` output-pixel tile per cluster of ``cluster`` CTAs;
    rank r expands E channels [r*es, (r+1)*es) and projects P channels
    [r*ps, (r+1)*ps) in chunks of ``pn``; the expand's K step is ``ck``
    (0 for a bare pair); ``stages`` cp.async buffers per ring; ``smem``
    dynamic shared-memory bytes; ``tiles`` pixel tiles per image; the
    grid is (tiles * cluster, n). ``reduce``: each rank projects its own
    E slice onto all P (``ps`` = P) and the cluster adds the f32 partials,
    instead of each rank gathering all of E for its P slice."""
    th: int
    tw: int
    cluster: int
    es: int
    ps: int
    ck: int
    pn: int
    stages: int
    reduce: int
    smem: int
    tiles: int

    @property
    def c_args(self):
        return (self.th, self.tw, self.cluster, self.es, self.ps, self.ck,
                self.pn, self.stages, self.reduce, self.smem)


def _r16(v: int) -> int:
    return -(-v // 16) * 16


def _r32(v: int) -> int:
    return -(-v // 32) * 32


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def fused_ir_smem_bytes(th, tw, cluster, es, ps, ck, pn, stages, expand,
                        reduce=0) -> int:
    """Dynamic shared memory of the kernel for a plan: the rank's dw slice
    [th*tw][es+8] bf16; its f32 dw taps and biases (11*es + ps floats,
    rounded up to 16 bytes); then the larger of the expand stage (window
    [mw][es+8] and ``stages`` x (x tile [mw][ck+8] + we tile
    [ck][r32(min(es,64))+8])) and the project stage (the gathered A tile
    [th*tw][cluster*es+8] where cluster > 1, and ``stages`` x wp tile
    [64][r32(pn)+8], bf16; in the reduce form the wp ring and an f32
    partial tile [th*tw][r32(pn)+4]); 16 bytes hold the gather's
    mbarrier.
    The C layout (csrc/fused_ir.cu, ``layout``) is the same formula, and
    the launch refuses a mismatch."""
    npix, mw = th * tw, _r16((th + 2) * (tw + 2))
    lds = es + 8
    slot_a = mw * (ck + 8) + ck * (_r32(min(es, 64)) + 8) if expand else 0
    a = mw * lds * 2 + stages * slot_a * 2
    ring = stages * PROJECT_K * (_r32(pn) + 8) * 2
    if reduce:
        b = ring + npix * (_r32(pn) + 4) * 4
    else:
        b = ring + (npix * (cluster * es + 8) * 2 if cluster > 1 else 0)
    return npix * lds * 2 + _r16((11 * es + ps) * 4) + 16 + max(a, b)


def _plan_one(n, h, w, cin, e, p, expand, th, tw, two_per_sm):
    """The plan for one pixel tile, or None where nothing fits."""
    npix, mw = th * tw, _r16((th + 2) * (tw + 2))
    tiles = _cdiv(h, th) * _cdiv(w, tw)
    budget = SMEM_TWO if two_per_sm else SMEM_MAX
    # CTAs the card holds at once: all SMs for single CTAs, about 15 of
    # 16-18 SMs per GPC for clusters (what cudaOccupancyMaxActiveClusters
    # reports for clusters of 8 on an H100 SXM)
    per_sm = 2 if two_per_sm else 1
    nblk = _cdiv(e, 16)
    if 2 * p <= e:      # the reduce form: ranks up to filling the card
        want = max(1, (SMS - 12) * per_sm // (tiles * n))
    else:               # the gather form moves cl slices to each rank: ranks
        # only up to one CTA an SM (plan_sweep.py: 2 ranks beat 3 at 32x32)
        want = _cdiv(SMS - 4, tiles * n)
    want = min(MAX_CLUSTER, nblk, want)
    # more ranks (thinner E slices) where a wide E does not fit
    for want in range(want, max(want, min(MAX_CLUSTER, nblk)) + 1):
        es = 16 * _cdiv(nblk, want)
        cluster = _cdiv(nblk, es // 16)
        # P small against E: each rank projects its own E slice onto all of
        # P and the ranks add their partials (reads P x 4 bytes a pixel from
        # the peers) rather than gather all of E (E x 2 bytes a pixel)
        reduce = int(cluster > 1 and 2 * p <= e)
        ps = p if reduce else _cdiv(p, 8 * cluster) * 8
        pn = min(128 if npix <= 64 else 96, _cdiv(ps, 8) * 8)
        cks = [0]
        if expand:
            cks = [c for c in (128, 64, 32) if mw * c // 8 <= X_COPIES]
            # deepest first, but never a step deeper than Cin needs
            cks = [c for c in cks if c < 2 * _r16(cin) or c == cks[-1]]
        for ck in cks:
            for stages in (3, 2):
                smem = fused_ir_smem_bytes(th, tw, cluster, es, ps, ck, pn, stages, expand,
                                           reduce)
                if smem <= budget:
                    return FusedIrPlan(th, tw, cluster, es, ps, ck, pn, stages, reduce, smem,
                                       tiles)
    return None


def _plan_cost(plan, n, cin, e, expand):
    """Waves of CTAs times the multiply-adds of one CTA: what the plan
    choice minimises."""
    th, tw = plan.th, plan.tw
    npix, mw = th * tw, _r16((th + 2) * (tw + 2))
    per_sm = 2 if plan.smem <= SMEM_TWO else 1
    cap = (SMS if plan.cluster == 1 else SMS - 12) * per_sm
    waves = _cdiv(plan.tiles * plan.cluster * n, cap)
    macs = (mw * _r16(cin) * plan.es if expand else 0) + npix * 9 * plan.es \
        + npix * (plan.es if plan.reduce else _r16(e)) * plan.ps
    return waves * macs


@functools.lru_cache(maxsize=None)
def plan_fused_ir(n: int, h: int, w: int, cin: int, e: int, p: int,
                  expand: bool = True) -> FusedIrPlan:
    """Tiles, cluster and stages of the fused-IR kernel for an (n, h, w,
    cin) input with E expanded and P output channels.

    Candidates: pixel tiles 8x16 (a 10x18 window, 1.4x the output
    pixels; only where W >= 16) and 8x8 (10x10, 1.56x), each with shared
    memory for two CTAs per SM or, failing that, one. For each:
    - cluster: enough ranks that the CTAs fill the card once (two per SM
      where the shared memory allows; one per SM for the gather form, whose
      copies grow with the cluster), at most 8 and at most one per 16
      expanded channels, and more where a wider E slice does not fit; E is
      cut into slices of a whole number of 16-channel steps and the cluster
      is as many ranks as those slices need, so no rank's E slice is empty;
    - ps = P / cluster rounded up to 8, projected in chunks of pn <= 128
      (96 for 8x16 tiles);
    - ck: the deepest of 128/64/32 that fits and is under twice Cin
      rounded to 16 (so 32 at Cin 24 and 32), 128 only where the x tile
      is at most X_COPIES 16-byte copies;
    - stages 3, else 2, as the shared memory allows.
    The plan with the fewest waves x multiply-adds per CTA wins. Plans
    are cached: a forward asks for the same 21 every time."""
    if min(n, h, w, cin, e, p) < 1:
        raise ValueError(f'plan_fused_ir: empty shape {(n, h, w, cin, e, p)}')
    shapes = ((8, 16), (8, 8)) if w >= 16 else ((8, 8),)
    if 2 * p > e and _cdiv(h, 8) * _cdiv(w, 8) * n < SMS:
        # the gather form under a cluster: 8x8 tiles, ranks to one CTA an
        # SM (plan_sweep.py at 32x32, E 256: 8x8 x 2 ranks beat 8x16 x 8)
        shapes = ((8, 8),)
    plans = []
    for th, tw in shapes:
        for two in (True, False):
            plan = _plan_one(n, h, w, cin, e, p, expand, th, tw, two)
            if plan is not None:
                plans.append(plan)
    if not plans:
        raise ValueError(f'fused_ir_conv: no plan fits {SMEM_MAX} B of shared memory '
                         f'for Cin={cin} E={e} P={p}')
    return min(plans, key=lambda pl: _plan_cost(pl, n, cin, e, expand))


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or t.device != device \
            or not t.is_contiguous():
        raise ValueError(f'fused_ir_conv: {name} must be a contiguous {dtype} '
                         f'tensor of shape {tuple(shape)} on {device}, got '
                         f'{t.dtype} {tuple(t.shape)} on {t.device} '
                         f'(contiguous={t.is_contiguous()})')


def launch_fused_ir(lib, x, we, be, wdw, bdw, wp, bp, out, act_e, act_dw,
                    act_p, stream: int) -> int:
    """One call of the C entry point ``fused_ir_launch`` of ``lib`` on
    checked tensors; returns its CUDA error code."""
    fn = lib.fused_ir_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 20 + [ctypes.c_void_p]
    n, h, w, cin = x.shape
    e, p = wdw.shape[1], wp.shape[1]
    plan = plan_fused_ir(n, h, w, cin, e, p, expand=we is not None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    return fn(ptr(x), ptr(we), ptr(be), ptr(wdw), ptr(bdw), ptr(wp), ptr(bp),
              ptr(out), n, h, w, cin, e, p, int(we is not None),
              ACT_CODES[act_e], ACT_CODES[act_dw], ACT_CODES[act_p], *plan.c_args,
              stream)


def max_active_clusters(lib, h, w, cin, e, p, expand, plan: FusedIrPlan) -> int:
    """``cudaOccupancyMaxActiveClusters`` for ``plan``: how many of its
    clusters the card holds at once (a negative CUDA error code if the
    query fails)."""
    fn = lib.fused_ir_max_active_clusters
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 16
    return fn(h, w, cin, e, p, int(expand), *plan.c_args)


def fused_ir_conv(x, we, be, wdw, bdw, wp, bp, *, act_e: str = 'relu6',
                  act_dw: str = 'relu6', act_p: str = 'linear'):
    """Fused [expand + act] -> [dw3x3 + act] -> [project + act] on NHWC
    bf16 ``x`` (N, H, W, Cin); ``we``/``be`` None for a bare pair
    (Cin == E). Returns (N, H, W, P) bf16. Launches the CUDA kernel for a
    CUDA tensor (RuntimeError when grad mode is on and an input requires
    grad: the kernel has no backward), runs ``fused_ir_reference`` for a
    CPU tensor."""
    if x.device.type == 'cpu':
        return fused_ir_reference(x, we, be, wdw, bdw, wp, bp, act_e=act_e,
                                  act_dw=act_dw, act_p=act_p)
    refuse_autograd('fused_ir_conv', x, we, be, wdw, bdw, wp, bp)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_ir_conv: no kernel for device {x.device}')
    for a in (act_e, act_dw, act_p):
        if a not in ACT_CODES:
            raise ValueError(f'fused_ir_conv: unsupported activation {a!r}')
    n, h, w, cin = x.shape
    e, p = wdw.shape[1], wp.shape[1]
    dev = x.device
    _check('x', x, torch.bfloat16, (n, h, w, cin), dev)
    if we is None:
        if cin != e:
            raise ValueError(f'fused_ir_conv: a bare pair needs Cin == E, got {cin} != {e}')
    else:
        _check('we', we, torch.bfloat16, (cin, e), dev)
        _check('be', be, torch.float32, (e,), dev)
    _check('wdw', wdw, torch.bfloat16, (9, e), dev)
    _check('bdw', bdw, torch.float32, (e,), dev)
    _check('wp', wp, torch.bfloat16, (e, p), dev)
    _check('bp', bp, torch.float32, (p,), dev)
    if cin % 8 or e % 8 or p % 8:
        raise ValueError(f'fused_ir_conv: the kernel copies 16-byte rows and needs Cin, E '
                         f'and P multiples of 8, got {cin}, {e}, {p}')
    if any(t.data_ptr() % 16 for t in (x, we, wp) if t is not None):
        raise ValueError('fused_ir_conv: x, we and wp must start on 16-byte boundaries')
    out = torch.empty((n, h, w, p), dtype=torch.bfloat16, device=dev)
    if out.numel() == 0:
        return out
    from pqdet_tpu_torch.ops._build import load_library
    rc = launch_fused_ir(load_library('fused_ir'), x, we, be, wdw, bdw, wp, bp,
                         out, act_e, act_dw, act_p,
                         torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'fused_ir_conv: kernel launch failed with CUDA error {rc}')
    fused_ir_conv.launches += 1
    return out


fused_ir_conv.launches = 0


def pad_fused_weights(we, be, wdw, bdw, wp, bp):
    """BN-fused OIHW weights -> the kernel's layout: we (Cin, E), wdw
    (9, E), wp (E, P). Unlike the JAX package, which zero-pads E and P to
    128 lanes, nothing is padded: the CUDA kernel masks ragged tiles.

    Inputs: we (E, Cin, 1, 1) or None, wdw (E, 1, 3, 3), wp (P, E, 1, 1).
    Returns (we, be, wdw9, bdw, wp, bp, cout)."""
    e = wdw.shape[0]
    cout = wp.shape[0]
    we2 = None if we is None else we.reshape(e, -1).t()
    be = None if be is None else be.reshape(-1)
    return (we2, be, wdw.reshape(e, 9).t(), bdw.reshape(-1),
            wp.reshape(cout, e).t(), bp.reshape(-1), cout)


def find_fused_triples(graph):
    """Scan a Graph for [1x1 conv] -> [dw3x3 s1 p1] -> [1x1 conv] chains
    whose inner activations feed ONLY the next node (not in last_use).
    Returns [(a, b, c)] node-index triples; also (None, b, c) bare dw+pw
    pairs when the dw's predecessor is not a fusable 1x1 but the dw
    channel count is a whole number of 128-channel tiles (the JAX
    package's selection rule, kept so both fuse the same chains)."""
    out = []
    nodes = graph.nodes
    last_use = graph.last_use

    def conv(n):
        return n.kind == 'convolutional'

    def is_pw(n):
        a = n.attrs
        return conv(n) and a['size'] == 1 and a['stride'] == 1 \
            and a['groups'] == 1 and a['activation'] in _FUSABLE_ACTS \
            and solve_padding(a['size'], a['padding'], a['pad']) == 0

    def is_dw_s1(n):
        # the kernel hard-codes SAME padding (pad=1)
        a = n.attrs
        return conv(n) and a['size'] == 3 and a['stride'] == 1 \
            and a['groups'] == n.in_channels \
            and n.in_channels == n.out_channels \
            and a['activation'] in _FUSABLE_ACTS \
            and solve_padding(a['size'], a['padding'], a['pad']) == 1

    used = set()
    for i in range(len(nodes) - 2):
        a, b, c = nodes[i], nodes[i + 1], nodes[i + 2]
        if i in used or not (is_pw(a) and is_dw_s1(b) and is_pw(c)):
            continue
        if last_use.get(a.index, -1) > b.index \
                or last_use.get(b.index, -1) > c.index:
            continue
        out.append((a.index, b.index, c.index))
        used.update((i, i + 1, i + 2))
    for i in range(len(nodes) - 1):
        b, c = nodes[i], nodes[i + 1]
        if i in used or i + 1 in used or not (is_dw_s1(b) and is_pw(c)):
            continue
        if last_use.get(b.index, -1) > c.index or b.in_channels % LANE:
            continue
        out.append((None, b.index, c.index))
        used.update((i, i + 1))
    return out


def prepare_fused_ir(network, fused_params):
    """Build the walk-time fusion table from BN-fused inference params:
    {start_node_index: {kernel weights + activations + skip set + end}}.
    Weights are cast once here: bf16 matrices, f32 biases."""
    table = {}
    nodes = {n.index: n for n in network.graph.nodes}
    for a, b, c in find_fused_triples(network.graph):
        pb, pc = fused_params[str(b)], fused_params[str(c)]
        if 'bn' in pb or 'bn' in pc or 'b' not in pb or 'b' not in pc:
            continue  # only BN-fused inference params
        if a is not None:
            pa = fused_params[str(a)]
            if 'bn' in pa or 'b' not in pa:
                continue
            we, be = pa['w'], pa['b']
            act_e = nodes[a].attrs['activation']
        else:
            we = be = None
            act_e = 'linear'
        we, be, wdw, bdw, wp, bp, cout = pad_fused_weights(
            we, be, pb['w'], pb['b'], pc['w'], pc['b'])
        bf16 = lambda t: t.to(torch.bfloat16).contiguous()  # noqa: E731
        f32 = lambda t: t.to(torch.float32).contiguous()  # noqa: E731
        start = a if a is not None else b
        table[start] = dict(
            we=None if we is None else bf16(we), be=None if be is None else f32(be),
            wdw=bf16(wdw), bdw=f32(bdw), wp=bf16(wp), bp=f32(bp), cout=cout,
            act_e=act_e, act_dw=nodes[b].attrs['activation'],
            act_p=nodes[c].attrs['activation'],
            skip=tuple(i for i in (a, b, c) if i is not None and i != start),
            end=c)
    return table
