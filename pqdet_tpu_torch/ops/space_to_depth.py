"""Space-to-depth stem ingest (the port of ``pqdet_tpu/ops/space_to_depth.py``).

The input (B, H, W, 3) is reshaped to (B, H/r, W/r, 3 r^2) before the stem
conv and the stem's weights are folded to match, which preserves the
function. With the zoo's stem (3x3 stride-2 conv, pad 1) and r == stride
== 2, output pixel y[p, q] reads input rows {2p-1, 2p, 2p+1}, which lie in
s2d rows {p-1, p}: the folded kernel is 2x2 at stride 1 over 12 channels
with the asymmetric padding (1, 0), and its tap (di=0, a=0) is zero.

Weights here are OIHW (``bridge.py``'s HWIO -> OIHW rule); the s2d channel
index is (a, b, c) with c minor, so tap (u, v) of the stem lands in
channel block (a r + b) Cin of the folded kernel. ``fold_stem_weight`` is
the numpy fold of the JAX package's (HWIO, float64 scatter);
``fold_stem_weight_t`` the same scatter in torch, differentiable, for the
train step's live weights.
"""

from __future__ import annotations

import numpy as np
import torch


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/r, W/r, C r^2); channel index (a, b, c) with
    a, b the row and column offsets inside the block (c minor)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // r, w // r, r * r * c)


def _spans(kh: int, kw: int, r: int, stride: int, padding: int):
    if r != stride:
        raise ValueError(f's2d fold needs r == stride, got {r} vs {stride}')
    dlo, dhi = (0 - padding) // r, (kh - 1 - padding) // r
    elo, ehi = (0 - padding) // r, (kw - 1 - padding) // r
    return dlo, dhi, elo, ehi


def fold_stem_weight(w: np.ndarray, r: int, stride: int, padding: int):
    """Fold an HWIO kernel to run at stride 1 on space-to-depth(r) input:
    (folded HWIO kernel over C r^2 inputs, (pad_lo, pad_hi) of H, of W).
    Needs r == stride."""
    kh, kw, cin, cout = w.shape
    dlo, dhi, elo, ehi = _spans(kh, kw, r, stride, padding)
    wf = np.zeros((dhi - dlo + 1, ehi - elo + 1, r * r * cin, cout), np.float64)
    for u in range(kh):
        di, a = divmod(u - padding, r)
        for v in range(kw):
            dj, b = divmod(v - padding, r)
            blk = (a * r + b) * cin
            wf[di - dlo, dj - elo, blk:blk + cin, :] = w[u, v]
    return wf.astype(w.dtype), (-dlo, dhi), (-elo, ehi)


def fold_stem_weight_t(w: torch.Tensor, r: int, stride: int, padding: int):
    """``fold_stem_weight`` on an OIHW tensor, in torch: the scatter is
    linear, so the grads of the folded kernel flow back to ``w``. Returns
    (folded OIHW kernel, (pad_lo, pad_hi) of H, of W)."""
    cout, cin, kh, kw = w.shape
    dlo, dhi, elo, ehi = _spans(kh, kw, r, stride, padding)
    taps = {}
    for u in range(kh):
        di, a = divmod(u - padding, r)
        for v in range(kw):
            dj, b = divmod(v - padding, r)
            taps[(di - dlo, dj - elo, a * r + b)] = w[:, :, u, v]
    zero = w.new_zeros(cout, cin)
    nkh, nkw = dhi - dlo + 1, ehi - elo + 1
    # (nkh, nkw, r*r blocks) of (Cout, Cin) -> OIHW over Cin r^2 channels
    blocks = torch.stack([torch.stack([torch.cat([taps.get((i, j, k), zero)
                                                  for k in range(r * r)], dim=1)
                                       for j in range(nkw)], dim=-1)
                          for i in range(nkh)], dim=-2)
    return blocks, (-dlo, dhi), (-elo, ehi)


def stem_foldable(node) -> bool:
    """True when ``node`` (the graph's first) is a foldable stem: a conv of
    3 input channels at stride 2, ungrouped."""
    a = node.attrs
    return (node.kind == 'convolutional' and a['stride'] == 2
            and a['groups'] == 1 and node.in_channels == 3)
