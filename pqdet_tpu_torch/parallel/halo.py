"""The halo exchange of spatial partitioning (``train.spatial``).

Under a (data x space) mesh (``parallel/mesh.py::make_mesh_2d``) each rank
holds one band of an activation's rows. A conv or max pool whose window
reaches past the band needs its neighbours' edge rows: JAX's GSPMD inserts
that exchange itself; here it is written out. The forward pads the band
with ``top`` rows from the band above and ``bottom`` rows from the band
below, and with the op's own padding value (0 for a conv, -inf for a max
pool) at the image's top and bottom edges. The backward sends each halo
row's gradient to the rank that owns the row and adds it there: the
transpose of the forward.

An input height that the bands x the graph's total stride do not divide
(GSPMD pads such uneven shards) is walked padded: the step pads the image
and its label grids with zero rows up to ``padded_height``, so that every
op still maps whole bands and the halos stay neighbour-only, and carries
the real height in ``SpatialCtx.rows``. The walk keeps every activation's
rows past its real height (``Network.real_rows``) at the reading op's own
padding value (``fill_rows``: 0 before a conv, -inf before a max pool) and
counts real rows only in BN's moments, the band-sum average pool, the
QAT observers and the loss, so the result is the unpadded computation's.

One exchange is one ``all_gather`` over the space group of every rank's
(first ``bottom`` rows, last ``top`` rows); each rank then takes what its
neighbours sent. Point-to-point ``send``/``recv`` would move less, but
gloo's take CPU tensors only, and two ranks sharing one card run gloo;
``all_gather`` takes CUDA tensors on NCCL and gloo alike, and the space
axis is short. Every rank of a space group runs the same layers in the
same order, so their collectives pair up.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist


def band_rows(h: int, size: int, stride: int, pad: int, n_space: int,
              what: str) -> Tuple[int, int, int]:
    """(top, bottom, output rows) of a window op on a band of ``h`` rows:
    the rows to take from the band above and below so that the op, run
    with no row padding, gives exactly this band's rows of the unsharded
    op's output (``size`` window, ``stride``, ``pad`` rows of padding on
    either side of the whole image). Raises ``ValueError`` naming ``what``
    when the output bands would not line up with the input bands (a band
    height the stride does not divide) or when a halo is deeper than a
    neighbour's band."""
    h_out_all = (n_space * h + 2 * pad - size) // stride + 1
    h_out = h_out_all // n_space
    if h_out_all % n_space or h_out * stride != h:
        raise ValueError(f'{what}: a band of {h} rows does not map onto whole output bands '
                         f'(size {size}, stride {stride}, padding {pad}, {n_space} bands); '
                         'the walk\'s input must be padded to a multiple of the bands x the '
                         'total stride (padded_height)')
    top, bottom = pad, max(0, (h_out - 1) * stride + size - pad - h)
    if max(top, bottom) > h:
        raise ValueError(f'{what}: a halo of {max(top, bottom)} rows is deeper than the '
                         f'neighbouring band of {h} rows; use fewer bands or a larger input')
    return top, bottom, h_out


def padded_height(height: int, n_space: int, total_stride: int) -> int:
    """The rows an input ``height`` rows high is walked at on ``n_space``
    bands: the next multiple of the bands x ``total_stride``. Raises
    ``ValueError`` unless ``total_stride`` divides ``height``: the whole
    image's label grids (``height // stride`` rows) would not line up with
    its heads, in one process as on bands."""
    if height % total_stride:
        raise ValueError(f'input height {height} is not a multiple of the graph\'s total '
                         f'stride {total_stride}: its label grids would not match its heads')
    unit = n_space * total_stride
    return -(-height // unit) * unit


def band_real_rows(h: int, rows, spatial) -> int:
    """How many of band ``spatial.s``'s ``h`` rows lie above global row
    ``rows`` (the real rows of a padded activation; all ``h`` when ``rows``
    is None)."""
    if rows is None:
        return h
    return min(max(rows - spatial.offset(h), 0), h)


def fill_rows(x: torch.Tensor, rows, fill: float, spatial) -> torch.Tensor:
    """Band ``x`` (NHWC-like, rows on dim 1) with its rows at global row
    ``rows`` and past set to ``fill``, without gradient there; ``x`` itself
    when ``rows`` is None or the band holds no such row."""
    h = x.shape[1]
    k = band_real_rows(h, rows, spatial)
    if k == h:
        return x
    keep = (torch.arange(h, device=x.device) < k).view((1, h) + (1,) * (x.dim() - 2))
    return torch.where(keep, x, x.new_full((), fill))


def _gather(t: torch.Tensor, group, n: int) -> list:
    """The space group's ``t`` in rank order. A bf16 tensor travels as its
    bytes (exact), which every backend takes on either device."""
    t = t.contiguous()
    wire = t.view(torch.uint8) if t.dtype == torch.bfloat16 else t
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    return [p.view(t.dtype) for p in parts] if wire is not t else parts


class _Halo(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, top, bottom, fill, group, s, n):
        b, h, w, c = x.shape
        ctx.top, ctx.bottom, ctx.group, ctx.s, ctx.n, ctx.h = top, bottom, group, s, n, h
        parts = _gather(torch.cat([x[:, :bottom], x[:, h - top:]], 1), group, n)
        up = parts[s - 1][:, bottom:] if s > 0 else x.new_full((b, top, w, c), fill)
        down = parts[s + 1][:, :bottom] if s < n - 1 else x.new_full((b, bottom, w, c), fill)
        return torch.cat([up, x, down], 1)

    @staticmethod
    def backward(ctx, g):
        top, bottom, s, n, h = ctx.top, ctx.bottom, ctx.s, ctx.n, ctx.h
        parts = _gather(torch.cat([g[:, :top], g[:, top + h:]], 1), ctx.group, n)
        grad = g[:, top:top + h].clone()
        if s < n - 1 and top:       # the band below took my last rows as its top halo
            grad[:, h - top:] += parts[s + 1][:, :top]
        if s > 0 and bottom:        # the band above took my first rows as its bottom halo
            grad[:, :bottom] += parts[s - 1][:, top:]
        return grad, None, None, None, None, None, None


def halo_pad(x: torch.Tensor, top: int, bottom: int, fill: float, spatial) -> torch.Tensor:
    """NHWC band ``x`` with ``top`` rows of the band above and ``bottom`` of
    the band below (``fill`` rows at the image's edges), differentiable:
    the backward adds each halo row's gradient on the rank that owns the
    row. ``spatial`` is the rank's ``SpatialCtx``; no collective runs when
    both counts are 0."""
    if not (top or bottom):
        return x
    return _Halo.apply(x, int(top), int(bottom), float(fill), spatial.space, spatial.s,
                       spatial.n_space)
