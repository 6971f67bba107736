"""On-device training augmentation (the port of
``pqdet_tpu/ops/augment_device.py``, ``augment.device: on``).

The host decodes and letterboxes each sample once and ships uint8; every
stochastic transform runs batched on the device inside the train step:

  hflip/vflip -> zoom-crop (SafeCrop + letterbox as one bilinear warp) ->
  color jitter -> mosaic -> mixup -> (round to the uint8 domain)

Each stage computes what the JAX stage computes, operation for operation,
in f32 PyTorch ops (no hand-written kernel: the JAX package computes all of
it outside Pallas). Where JAX's CPU compiler contracts a multiply and an
add into one rounding (the saturation blend, the crop's integer draws, the
zoom's box affine and the warp's pad blend), the port rounds once too, in
f64 (``_fma``), so a ``floor`` sees the value JAX's sees; every other
multiply and add is its own pass, as in JAX.

Random draws are explicit. ``jax.random``'s streams cannot be reproduced in
PyTorch, so each stage takes its random values as arguments and
``AugmentDraws`` holds all of one call's values at the points where JAX
draws them: the Bernoulli uniforms of each stage, the crop's four uniforms,
the jitter's factors and op order, mosaic's three partner permutations and
centre, mixup's permutation and ``lam``. ``draw_augment`` makes the record
from a numpy ``Generator`` on the host (the trainer seeds it from
``(system.seed, global_step)``), and ``AugmentDraws.to`` uploads it in one
pinned, non-blocking copy, so the chain on the card never waits on the
host and never makes the host wait.

The matmul form of the letterbox warp is the only warp: JAX's
``PQDET_AUG_WARP`` knob and its gather form are not ported. Its two
products run in full f32 whatever the process's TF32 setting (JAX pins
``precision='highest'``: a reduced-precision blend breaks the warp's
parity).

Boxes are (B, G, 6) [x1, y1, x2, y2, class, mixup_w] zero-padded rows;
mosaic grows G 4x and mixup appends the partner rows, so G becomes 5G with
both on (``ops/labels.py`` takes any G).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

# the jitter's factor ranges (JAX's color_jitter defaults)
BRIGHTNESS = (-0.1, 0.1)
CONTRAST = (0.8, 1.2)
SATURATION = (0.1, 2.0)
MIXUP_BETA = 1.5


def _valid(boxes: torch.Tensor) -> torch.Tensor:
    """(..., G) mask of non-degenerate rows."""
    return (boxes[..., 2] > boxes[..., 0]) & (boxes[..., 3] > boxes[..., 1])


def _where_boxes(mask_b, a, b):
    return torch.where(mask_b[:, None, None], a, b)


def _fma(a, b, c):
    """``a * b + c`` rounded once to f32, as XLA's CPU compiler contracts
    it: the f64 product of two f32 values is exact, and the f64 sum rounds
    to f32 as the fused operation does (a double rounding could part them
    only on an f64 sum that ties at f32 precision). The same on the CPU and
    the card."""
    return (a.double() * b.double() + c.double()).float()


def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` as IEEE division: PyTorch computes a Python number over
    a tensor as the tensor's reciprocal times the number, two roundings."""
    return torch.full_like(den, num) / den


@contextlib.contextmanager
def _full_f32_matmul():
    """f32 matmuls without TF32 inside, whatever the process set."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


# --------------------------------------------------------------- flips

def hflip(images, boxes, apply_b):
    """Horizontal flip (host RandomHFlip) where ``apply_b``."""
    S = images.shape[2]
    fb = boxes.clone()
    fb[..., 0] = S - boxes[..., 2]
    fb[..., 2] = S - boxes[..., 0]
    fb = torch.where(_valid(boxes)[..., None], fb, boxes)
    return (torch.where(apply_b[:, None, None, None], images.flip(2), images),
            _where_boxes(apply_b, fb, boxes))


def vflip(images, boxes, apply_b):
    S = images.shape[1]
    fb = boxes.clone()
    fb[..., 1] = S - boxes[..., 3]
    fb[..., 3] = S - boxes[..., 1]
    fb = torch.where(_valid(boxes)[..., None], fb, boxes)
    return (torch.where(apply_b[:, None, None, None], images.flip(1), images),
            _where_boxes(apply_b, fb, boxes))


# ----------------------------------------------------------- zoom crop

def _axis_weights(n, lo, extent, r_ext, d0):
    """(B, n_out, n_in) bilinear interpolation matrices for one axis of the
    letterbox warp, one per sample: output pixel centres map to src =
    (i - d0 + 0.5) * (extent / r_ext) - 0.5 + lo (cv2's resize
    convention), clamped to the crop; rows outside the resized content are
    zero (the caller adds the pad there). Each row has at most two
    non-zeros: the matrix is the bilinear gather as a matmul."""
    idx = torch.arange(n, dtype=torch.float32, device=lo.device)
    t = idx[None, :] - d0[:, None] + 0.5
    src = _fma(t, (extent / r_ext)[:, None], torch.full_like(t, -0.5)) + lo[:, None]
    src = torch.minimum(torch.maximum(src, lo[:, None]), (lo + extent - 1)[:, None])
    inside = (idx[None, :] >= d0[:, None]) & (idx[None, :] < (d0 + r_ext)[:, None])
    f = torch.floor(src)
    frac = src - f
    cells = idx[None, None, :]
    w = (torch.where(cells == f[..., None], (1 - frac)[..., None], 0.)
         + torch.where(cells == (f + 1)[..., None], frac[..., None], 0.))
    return torch.where(inside[..., None], w, 0.)


def _letterbox_warp_mm(img, x0, y0, cw, ch, rw, rh, dl, du, pad_val=128.0):
    """Crop rect [x0, x0+cw) x [y0, y0+ch) of each (H, W, C) image,
    bilinear-resized to (rh, rw) and placed at (du, dl) on a ``pad_val``
    canvas, as two interpolation matmuls (rows, then columns) in full f32."""
    B, H, W, C = img.shape
    wy = _axis_weights(H, y0, ch, rh, du)              # (B, H, H_in)
    wx = _axis_weights(W, x0, cw, rw, dl)              # (B, W, W_in)
    with _full_f32_matmul():
        out = torch.matmul(wy, img.reshape(B, H, W * C))                # (B, H, W_in*C)
        out = out.view(B, H, W, C).transpose(1, 2).reshape(B, W, H * C)
        out = torch.matmul(wx, out).view(B, W, H, C).transpose(1, 2)    # (B, H, W, C)
    # the pad where either axis contributed nothing (outside the content)
    coverage = wy.sum(2)[:, :, None] * wx.sum(2)[:, None, :]
    return _fma((1. - coverage)[..., None], torch.full_like(coverage[..., None], pad_val), out)


def zoom_crop(images, boxes, box_u, apply_b, pad_val=128.0):
    """RandomSafeCrop + letterbox as one bilinear warp per sample, where
    ``apply_b``. ``box_u``: (4, B) uniforms of the crop's x0, y0, x1 and y1
    (each an integer drawn in its range, so the crop never cuts a valid
    box). The crop is resized keeping its aspect and centred back on the
    source size (host Resize semantics)."""
    B, H, W = images.shape[:3]
    val = _valid(boxes)
    any_box = val.any(dim=1)
    big = 1e9
    hx0 = torch.where(val, boxes[..., 0], big).amin(1)
    hy0 = torch.where(val, boxes[..., 1], big).amin(1)
    hx1 = torch.where(val, boxes[..., 2], -big).amax(1)
    hy1 = torch.where(val, boxes[..., 3], -big).amax(1)
    # box-free samples crop around the centre point (host hull fallback)
    hx0 = torch.where(any_box, torch.floor(hx0), float(W // 2))
    hy0 = torch.where(any_box, torch.floor(hy0), float(H // 2))
    hx1 = torch.where(any_box, torch.ceil(hx1), float(W // 2 + 1))
    hy1 = torch.where(any_box, torch.ceil(hy1), float(H // 2 + 1))

    def ri(u, lo, hi):  # an integer in [lo, hi], per sample
        return torch.floor(_fma(u, hi - lo + 1 - 1e-6, lo))

    zeros = torch.zeros_like(hx0)
    x0 = ri(box_u[0], zeros, hx0.clamp(0, W))
    y0 = ri(box_u[1], zeros, hy0.clamp(0, H))
    x1 = ri(box_u[2], hx1.clamp(0, W), torch.full_like(hx1, W))
    y1 = ri(box_u[3], hy1.clamp(0, H), torch.full_like(hy1, H))
    cw, ch = x1 - x0, y1 - y0
    ratio = torch.minimum(_div(W, cw), _div(H, ch))
    rw = torch.round(ratio * cw)
    rh = torch.round(ratio * ch)
    dl = torch.floor((W - rw) / 2)
    du = torch.floor((H - rh) / 2)

    warped = _letterbox_warp_mm(images, x0, y0, cw, ch, rw, rh, dl, du, pad_val=pad_val)
    r = ratio[:, None]
    nb = boxes.clone()
    for col, off, d in ((0, x0, dl), (2, x0, dl), (1, y0, du), (3, y0, du)):
        nb[..., col] = _fma(boxes[..., col] - off[:, None], r, d[:, None].expand_as(r))
    nb = torch.where(val[..., None], nb, boxes)
    return (torch.where(apply_b[:, None, None, None], warped, images),
            _where_boxes(apply_b, nb, boxes))


# -------------------------------------------------------- color jitter

def _cv2_gray(img):
    """cv2's fixed-point RGB2GRAY, (R*9798 + G*19235 + B*3735 + 16384) >> 15;
    every intermediate is an integer below 2^24, exact in f32."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    return torch.floor((r * 9798. + g * 19235. + b * 3735. + 16384.) / 32768.)


def _slot_ops(order):
    """(3, B) op index (0 brightness, 1 contrast, 2 saturation) of each of
    the jitter's three slots for permutation ``order`` in [0, 6), the rows
    of [[0,1,2], [0,2,1], [1,0,2], [1,2,0], [2,0,1], [2,1,0]]."""
    first = torch.div(order, 2, rounding_mode='floor')
    low = (first == 0).long()                 # the smaller of the other two
    high = 2 - (first == 2).long()            # the larger
    even = order % 2 == 0
    return torch.stack([first, torch.where(even, low, high), torch.where(even, high, low)])


def color_jitter(images, brightness, contrast, saturation, order, apply_b):
    """Brightness, contrast and saturation in the per-sample ``order``
    (host ColorJitter's uint8 formulas in float): brightness adds its
    rounded offset and clips; contrast scales, clips and truncates;
    saturation blends with the cv2-rounded gray, clips and truncates.
    ``brightness``, ``contrast``, ``saturation``: (B,) factors drawn in
    BRIGHTNESS, CONTRAST and SATURATION."""
    bf = torch.round(brightness * 255.)[:, None, None, None]
    cf = contrast[:, None, None, None]
    sf = saturation[:, None, None, None]

    def _b(img):
        return (img + bf).clamp(0., 255.)

    def _c(img):
        return torch.floor((img * cf).clamp(0., 255.))

    def _s(img):
        gray = _cv2_gray(img)[..., None]
        return torch.floor(_fma(sf, img, (1. - sf) * gray).clamp(0., 255.))

    x = images
    for j in _slot_ops(order):
        j = j[:, None, None, None]
        x = torch.where(j == 0, _b(x), torch.where(j == 1, _c(x), _s(x)))
    return torch.where(apply_b[:, None, None, None], x, images)


# -------------------------------------------------------------- mosaic

def mosaic_place(images4, boxes4, xc, yc):
    """The mosaic placement: 4 input-size sources on the virtual (2S, 2S)
    canvas, centre-cropped to (S, S) (host Mosaic with full-size sources:
    no resampling, no canvas pad in the crop).

    images4: (B, 4, S, S, C); boxes4: (B, 4, G, 6); xc, yc: (B,) integer
    tensors in [S/2, 3S/2), S even. Source k lands top (k < 2) or bottom,
    left (k even) or right; the crop window splits at (yc + S/2 - S, xc +
    S/2 - S) into the four sources' corners, so each output pixel is one
    gathered source pixel (no branch on the device values, no host sync).
    Returns (B, S, S, C) images and (B, 4G, 6) boxes."""
    B, _, S = images4.shape[:3]
    if S % 2:
        raise ValueError(f'mosaic_place needs an even size, got {S}')
    C = images4.shape[-1]
    G = boxes4.shape[2]
    half = S // 2
    dev = images4.device
    ar = torch.arange(S, device=dev)
    ty = (yc.long() + half - S)[:, None]                 # first bottom row, (B, 1)
    tx = (xc.long() + half - S)[:, None]
    top = ar[None, :] < ty
    left = ar[None, :] < tx
    sy = torch.where(top, ar + S - ty, ar - ty)          # (B, S) source row
    sx = torch.where(left, ar + S - tx, ar - tx)
    k = (~top).long()[:, :, None] * 2 + (~left).long()[:, None, :]           # (B, S, S)
    flat = ((torch.arange(B, device=dev)[:, None, None] * 4 + k) * S
            + sy[:, :, None]) * S + sx[:, None, :]
    out_images = images4.reshape(-1, C).index_select(0, flat.reshape(-1)).view(B, S, S, C)

    # boxes: per source, clip to the pasted rect, then the source->virtual
    # offset, then the centre-crop shift
    xcf = xc.float()[:, None]
    ycf = yc.float()[:, None]
    Sf = float(S)
    obs = []
    for kk in range(4):
        right, bottom = kk % 2 == 1, kk >= 2
        xb0 = torch.zeros_like(xcf) if right else (Sf - xcf).clamp(min=0.)
        xb2 = (2 * Sf - xcf).clamp(max=Sf) if right else torch.full_like(xcf, Sf)
        yb0 = torch.zeros_like(ycf) if bottom else (Sf - ycf).clamp(min=0.)
        yb2 = (2 * Sf - ycf).clamp(max=Sf) if bottom else torch.full_like(ycf, Sf)
        offx = xcf if right else xcf - Sf
        offy = ycf if bottom else ycf - Sf
        b = boxes4[:, kk]
        nb = b.clone()
        nb[..., 0] = torch.minimum(torch.maximum(b[..., 0], xb0), xb2) + offx
        nb[..., 2] = torch.minimum(torch.maximum(b[..., 2], xb0), xb2) + offx
        nb[..., 1] = torch.minimum(torch.maximum(b[..., 1], yb0), yb2) + offy
        nb[..., 3] = torch.minimum(torch.maximum(b[..., 3], yb0), yb2) + offy
        obs.append(nb)
    nb = torch.cat(obs, dim=1)                           # (B, 4G, 6), virtual frame
    merged = nb.clone()
    merged[..., :4] = (nb[..., :4] - Sf / 2).clamp(0., Sf)

    # degenerate-box filter (host filter_degenerate_boxes with mosaic
    # thresholds: iou 0.2, area 25, aspect 10)
    orig = boxes4.reshape(B, 4 * G, 6)
    w = merged[..., 2] - merged[..., 0]
    h = merged[..., 3] - merged[..., 1]
    area = w * h
    area0 = (orig[..., 2] - orig[..., 0]) * (orig[..., 3] - orig[..., 1])
    aspect = torch.maximum(w / (h + 1e-16), h / (w + 1e-16))
    keep = (area > 25.) & (area / (area0 + 1e-16) > 0.2) & (aspect < 10.) & _valid(orig)
    return out_images, torch.where(keep[..., None], merged, 0.)


def mosaic(images, boxes, perms, xc, yc, apply_b):
    """In-batch mosaic where ``apply_b``: partners are rows ``perms`` (3, B)
    of the batch, centres (xc, yc); samples not applied pass through with
    their boxes zero-padded to 4G."""
    G = boxes.shape[1]
    images4 = torch.stack([images] + [images.index_select(0, p) for p in perms], dim=1)
    boxes4 = torch.stack([boxes] + [boxes.index_select(0, p) for p in perms], dim=1)
    out, ob = mosaic_place(images4, boxes4, xc, yc)
    passthrough = torch.cat([boxes, boxes.new_zeros(boxes.shape[0], 3 * G, 6)], dim=1)
    return (torch.where(apply_b[:, None, None, None], out, images),
            _where_boxes(apply_b, ob, passthrough))


# --------------------------------------------------------------- mixup

def mixup(images, boxes, partner_images, partner_boxes, lam, apply_b):
    """Beta blend with a partner sample (host Mixup): own boxes get weight
    ``lam``, the partner's 1 - lam; samples not applied keep weight 1 and
    zeroed partner rows."""
    lam_i = torch.where(apply_b, lam, 1.0)
    out = (images * lam_i[:, None, None, None]
           + partner_images * (1. - lam_i)[:, None, None, None])
    out = torch.round(out)  # cv2.addWeighted rounds to uint8
    v = _valid(boxes)
    own = boxes.clone()
    own[..., 5] = torch.where(v, lam_i[:, None], boxes[..., 5])
    pv = _valid(partner_boxes)
    pb = partner_boxes.clone()
    pb[..., 5] = torch.where(pv, (1. - lam_i)[:, None], partner_boxes[..., 5])
    pb = torch.where(apply_b[:, None, None], pb, torch.zeros_like(pb))
    return (torch.where(apply_b[:, None, None, None], out, images),
            torch.cat([own, pb], dim=1))


# ---------------------------------------------------------- the draws

@dataclasses.dataclass
class AugmentDraws:
    """Every random value of one ``device_augment`` call. N rows for the
    base chain (the batch B, or B plus its fresh partner rows), B for
    mosaic and mixup. Uniforms are in [0, 1); a stage applies to a row
    where its uniform is below the stage's probability."""
    hflip: torch.Tensor          # (N,)
    vflip: torch.Tensor          # (N,)
    crop: torch.Tensor           # (N,)
    crop_box: torch.Tensor       # (4, N): x0, y0, x1, y1
    color: torch.Tensor          # (N,)
    brightness: torch.Tensor     # (N,) in BRIGHTNESS
    contrast: torch.Tensor       # (N,) in CONTRAST
    saturation: torch.Tensor     # (N,) in SATURATION
    order: torch.Tensor          # (N,) int in [0, 6): the jitter's op order
    mosaic: torch.Tensor         # (B,)
    mosaic_perm: torch.Tensor    # (3, B) int: in-batch partners
    xc: torch.Tensor             # (B,) int in [S/2, 3S/2)
    yc: torch.Tensor             # (B,) int
    mixup: torch.Tensor          # (B,)
    mixup_perm: torch.Tensor     # (B,) int: the in-batch partner
    lam: torch.Tensor            # (B,) Beta(MIXUP_BETA, MIXUP_BETA)

    INTS = ('order', 'mosaic_perm', 'xc', 'yc', 'mixup_perm')

    def to(self, device) -> 'AugmentDraws':
        """The record on ``device``: on a card, all of it in one pinned,
        non-blocking upload (every value is exact in f32), split there."""
        device = torch.device(device)
        names = [f.name for f in dataclasses.fields(self)]
        vals = [getattr(self, n) for n in names]
        if device.type != 'cuda':
            return AugmentDraws(**{n: v.to(device) for n, v in zip(names, vals)})
        flat = torch.cat([v.reshape(-1).float() for v in vals]).pin_memory()
        flat = flat.to(device, non_blocking=True)
        out = {}
        for n, v, part in zip(names, vals, torch.split(flat, [v.numel() for v in vals])):
            part = part.view(v.shape)
            out[n] = part.long() if n in self.INTS else part
        return AugmentDraws(**out)


def draw_augment(gen: np.random.Generator, batch: int, size: int,
                 partner_rows: int = 0) -> AugmentDraws:
    """The draws of one ``device_augment`` call on a batch of ``batch``
    images of ``size``^2, with ``partner_rows`` fresh partner rows per
    sample (N = batch * (1 + partner_rows)), from ``gen``; CPU tensors."""
    n = batch * (1 + partner_rows)
    f32 = np.float32

    def u(*shape):
        return gen.random(shape, dtype=f32)

    def within(lo_hi, k):
        lo, hi = f32(lo_hi[0]), f32(lo_hi[1])
        return u(k) * (hi - lo) + lo

    vals = dict(
        hflip=u(n), vflip=u(n), crop=u(n), crop_box=u(4, n), color=u(n),
        brightness=within(BRIGHTNESS, n), contrast=within(CONTRAST, n),
        saturation=within(SATURATION, n), order=gen.integers(0, 6, n),
        mosaic=u(batch), mosaic_perm=np.stack([gen.permutation(batch) for _ in range(3)]),
        xc=gen.integers(size // 2, size + size // 2, batch),
        yc=gen.integers(size // 2, size + size // 2, batch),
        mixup=u(batch), mixup_perm=gen.permutation(batch),
        lam=gen.beta(MIXUP_BETA, MIXUP_BETA, batch).astype(f32))
    return AugmentDraws(**{k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in vals.items()})


# ---------------------------------------------------------- the chain

class AugmentParams(NamedTuple):
    hflip_p: float = 0.5
    vflip_p: float = 0.0
    crop_p: float = 0.75
    color_p: float = 0.0
    mosaic_p: float = 0.0
    mixup_p: float = 0.5


def _base_chain(img, boxes, d: AugmentDraws, params: AugmentParams):
    """flips -> zoom-crop -> jitter (the host's standard chain) on a batch
    of any size: the main batch, and in fresh-partner mode the main batch
    and its partners in one pass."""
    if params.hflip_p > 0:
        img, boxes = hflip(img, boxes, d.hflip < params.hflip_p)
    if params.vflip_p > 0:
        img, boxes = vflip(img, boxes, d.vflip < params.vflip_p)
    if params.crop_p > 0:
        img, boxes = zoom_crop(img, boxes, d.crop_box, d.crop < params.crop_p)
        img = torch.round(img)  # back to the uint8 value domain
    if params.color_p > 0:
        img = color_jitter(img, d.brightness, d.contrast, d.saturation, d.order,
                           d.color < params.color_p)
    return img, boxes


def device_augment(images: torch.Tensor, gt: torch.Tensor, draws: AugmentDraws,
                   params: AugmentParams, partner_images: Optional[torch.Tensor] = None,
                   partner_gt: Optional[torch.Tensor] = None):
    """uint8 letterboxed batch (B, S, S, 3) + padded GT (B, G, 6) -> the
    augmented uint8 batch + grown padded GT, with the values of ``draws``
    (on the batch's device).

    Stage order is the host chain's: flips -> crop -> jitter -> mosaic ->
    mixup; a stage of probability 0 is skipped. ``partner_images`` /
    ``partner_gt`` (kB rows, fresh corpus rows from the trainer's device
    cache): the base chain runs once over the main batch and the partners
    with independent draws, rows [0:3B] of the partners feed mosaic (when
    on) and the next B feed mixup; without them, partners are in-batch
    permutations."""
    B = images.shape[0]
    G = gt.shape[1]
    img = images.float()
    boxes = gt.float()
    fresh = partner_images is not None
    rows = B + (partner_images.shape[0] if fresh else 0)
    if draws.hflip.shape[0] != rows or draws.mosaic.shape[0] != B:
        raise ValueError(f'draws for {draws.hflip.shape[0]} rows and batch '
                         f'{draws.mosaic.shape[0]}, the call has {rows} rows and batch {B}')
    if fresh:
        allimg = torch.cat([img, partner_images.float()])
        allbox = torch.cat([boxes, partner_gt.float()])
        allimg, allbox = _base_chain(allimg, allbox, draws, params)
        img, pimg = allimg[:B], allimg[B:]
        boxes, pbox = allbox[:B], allbox[B:]
    else:
        img, boxes = _base_chain(img, boxes, draws, params)
    if params.mixup_p > 0:
        # the host mixup partner is a base sample: snapshot before mosaic
        if fresh:
            off = 3 * B if params.mosaic_p > 0 else 0
            pre_img, pre_boxes = pimg[off:], pbox[off:]
        else:
            pre_img, pre_boxes = img, boxes
    if params.mosaic_p > 0:
        apply_b = draws.mosaic < params.mosaic_p
        if fresh:
            images4 = torch.stack([img, pimg[:B], pimg[B:2 * B], pimg[2 * B:3 * B]], dim=1)
            boxes4 = torch.stack([boxes, pbox[:B], pbox[B:2 * B], pbox[2 * B:3 * B]], dim=1)
            out, ob = mosaic_place(images4, boxes4, draws.xc, draws.yc)
            passthrough = torch.cat([boxes, boxes.new_zeros(B, 3 * G, 6)], dim=1)
            img = torch.where(apply_b[:, None, None, None], out, img)
            boxes = _where_boxes(apply_b, ob, passthrough)
        else:
            img, boxes = mosaic(img, boxes, draws.mosaic_perm, draws.xc, draws.yc, apply_b)
    if params.mixup_p > 0:
        if fresh:
            pmix_img, pmix_boxes = pre_img, pre_boxes
        else:
            pmix_img = pre_img.index_select(0, draws.mixup_perm)
            pmix_boxes = pre_boxes.index_select(0, draws.mixup_perm)
        img, boxes = mixup(img, boxes, pmix_img, pmix_boxes, draws.lam,
                           draws.mixup < params.mixup_p)
    else:
        # the weight column is 1 on valid rows (host Mixup sets it even
        # when it passes through)
        boxes = boxes.clone()
        boxes[..., 5] = _valid(boxes).float()
    return torch.round(img).clamp(0., 255.).to(torch.uint8), boxes


def fresh_partners_enabled(config) -> bool:
    """``augment.fresh_partners``: 'auto' enables fresh partners exactly
    when the device corpus cache can supply them."""
    mode = config.augment.fresh_partners
    if isinstance(mode, bool):
        return mode
    mode = str(mode).lower()
    if mode == 'auto':
        return bool(config.dataset.device_cache)
    return mode in ('on', 'true', '1', 'yes')


def partner_rows_per_sample(config) -> int:
    """Fresh partner rows per batch row the chain wants: 3 for mosaic and
    1 for mixup (0 without fresh partners)."""
    a = config.augment
    if not fresh_partners_enabled(config):
        return 0
    return (3 if a.mosaic_p > 0 else 0) + (1 if a.mixup_p > 0 else 0)


def augment_params(config) -> AugmentParams:
    a = config.augment
    return AugmentParams(hflip_p=float(a.hflip_p), vflip_p=float(a.vflip_p),
                         crop_p=float(a.crop_p), color_p=float(a.color_p),
                         mosaic_p=float(a.mosaic_p), mixup_p=float(a.mixup_p))


def augmenter_from_config(config):
    """(images_u8, gt, draws[, partner_images, partner_gt]) -> (images_u8,
    gt') bound to the config's ``augment`` group, for the train step."""
    params = augment_params(config)

    def fn(images, gt, draws, partner_images=None, partner_gt=None):
        return device_augment(images, gt, draws, params, partner_images=partner_images,
                              partner_gt=partner_gt)
    return fn
