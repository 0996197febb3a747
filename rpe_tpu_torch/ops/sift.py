"""SIFT detection + description (port of rpe_tpu/ops/sift.py), batched
over frames.

The reference maps one frame at a time; here every stage takes a leading
frame axis F and every reduction (extrema selection, per-octave quotas, the
secondary-orientation re-selection) stays per frame. The reference has no
Pallas kernel in SIFT; the port adds two of its own, P3 and P4
(csrc/sift_sample.cu), for the sums whose order on the card would depend on
the batch. It is the reference's algorithm step for step:

  1. scale space: 2x linear upsample (OpenCV firstOctave=-1; off with
     upscale_first=False), incremental separable Gaussian blurs as
     shift+multiply-add chains with reflect padding and float64->float32
     taps, DoG by subtraction;
  2. per octave: 26-neighbour DoG extrema from separable shift-maxes, a
     static top-`quota` selection (lowest index first among equal values,
     as `lax.top_k`; or the reference's "block2" two-per-block
     preselection), OpenCV's 5-step adjustLocalExtrema relocation with
     clipped cube gathers, contrast and Hessian edge checks;
  3. orientation: 36-bin histogram over a 24x24 separable bilinear grid of
     the keypoint's own layer (P3), [1,4,6,4,1] smoothing, parabolic peak,
     and a secondary keypoint per second peak >= 0.8 * max;
  4. descriptor: 4x4x8 trilinear histogram over a rotated window;
     normalise -> clip 0.2 -> renormalise (P4).

Where it runs: steps 1-2 and the peak logic are elementwise, gathers,
sorts and maxima, the same bits at any batch; on CUDA tensors the
histograms, their bilinear samples and the descriptor's norms go through
P3 and P4 (`orientation_hist`, `descriptor`), which sum each output in a
fixed order, so a frame's keypoints do not depend on the frames beside
it. On CPU tensors the wrappers take the plain versions
(`orientation_hist_plain`, `descriptor_plain`): one-hot products and
float32 matmuls, which the entry points run with TF32 off
(utils/device.full_precision), batch-invariant on one CPU thread (with
several, the descriptor's batched matmul splits its work by the batch).

Numerics: one-hots are built by comparison (zeros outside the range, as
`jax.nn.one_hot`); division by a constant goes through a device tensor
(`_div`) because CUDA PyTorch turns `x / python_scalar` into a reciprocal
multiply, which rounds differently from the reference's true division.
atan2/exp/cos/sin differ from XLA's by ULPs, so a histogram bin can flip:
the parity tests state tolerances.

Output: the reference's dict, (F, max_kpts, ...) -- xy float32 level-0
pixel coords, angle radians, level int32 (octave), score |DoG|, desc (128)
float32, valid bool -- octave by octave, each in descending score order,
zero-padded to max_kpts.
"""

from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SiftConfig
from ..utils.observability import htod
from . import kernels
from .orb import top_k_stable

_S = 3                 # scales per octave (OpenCV nOctaveLayers)
_SIGMA0 = 1.6
_INIT_SIGMA = 0.5      # assumed blur of the input image
_ORI_BINS = 36
_DESC_D = 4            # 4x4 spatial bins
_DESC_B = 8            # 8 orientation bins
_ORI_GRID = 24         # bilinear sample grid for the orientation window
_DESC_GRID = 24        # bilinear sample grid for the descriptor window
_EDGE_R = 10.0
_MAX_INTERP_STEPS = 5  # OpenCV SIFT_MAX_INTERP_STEPS
_BORDER = 5            # extrema closer to the octave edge are dropped
_PATCH_ROWS = 16       # patch rows gathered per step (bounds the index tensor)


def _div(x, c: float):
    """x / c as a true float32 division on x's device."""
    return x / htod(c, x.device, x.dtype)


@functools.lru_cache(maxsize=None)
def _blur_taps(sigma: float) -> np.ndarray:
    """Gaussian taps truncated at 4 sigma (cv2's auto ksize, 8 sigma + 1
    wide), normalised in float64 and rounded to float32."""
    ksize = int(2 * round(4.0 * sigma) + 1)
    r = ksize // 2
    xs = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(xs * xs) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def blur(imgs, sigma: float):
    """Separable Gaussian of (F, H, W) frames: reflect padding (edge not
    repeated), then a multiply-add chain over the taps in order, rows
    first -- the reference's `_blur` tap for tap."""
    if sigma <= 0.0:
        return imgs
    k = _blur_taps(sigma)
    r = len(k) // 2
    _, h, w = imgs.shape
    x = F.pad(imgs[:, None], (0, 0, r, r), mode="reflect")[:, 0]
    acc = None
    for t in range(len(k)):
        term = x[:, t:t + h, :] * float(k[t])
        acc = term if acc is None else acc + term
    x = F.pad(acc[:, None], (r, r, 0, 0), mode="reflect")[:, 0]
    acc = None
    for t in range(len(k)):
        term = x[:, :, t:t + w] * float(k[t])
        acc = term if acc is None else acc + term
    return acc


@functools.lru_cache(maxsize=None)
def _upsample_taps(n: int):
    """2x linear upsampling along an axis of length n as two taps per output
    sample: `jax.image.resize(..., "linear")`'s triangle weights at
    half-pixel centres, with out-of-range taps dropped and the rest
    renormalised (so the first and last outputs copy the edge samples)."""
    out = np.arange(2 * n, dtype=np.float64)
    s = (out + 0.5) / 2.0 - 0.5
    j0 = np.floor(s).astype(np.int64)
    f = s - j0
    w0, w1 = 1.0 - f, f
    j1 = j0 + 1
    lo, hi = j0 < 0, j1 > n - 1
    w0 = np.where(lo, 0.0, w0)
    w1 = np.where(hi, 0.0, w1)
    tot = w0 + w1
    w0, w1 = w0 / tot, w1 / tot
    j0 = np.clip(j0, 0, n - 1)
    j1 = np.clip(j1, 0, n - 1)
    return j0, j1, w0.astype(np.float32), w1.astype(np.float32)


def upsample2x(imgs):
    """(F, H, W) -> (F, 2H, 2W) separable linear upsampling (rows, then
    columns), each output the sum of its two weighted taps."""
    dev = imgs.device
    _, h, w = imgs.shape
    j0, j1, w0, w1 = (htod(a, dev) for a in _upsample_taps(h))
    x = imgs[:, j0, :] * w0[:, None] + imgs[:, j1, :] * w1[:, None]
    j0, j1, w0, w1 = (htod(a, dev) for a in _upsample_taps(w))
    return x[:, :, j0] * w0 + x[:, :, j1] * w1


def _level_sigmas():
    """Incremental blur between consecutive Gaussian levels of an octave."""
    k = 2.0 ** (1.0 / _S)
    sig = [_SIGMA0]
    for i in range(1, _S + 3):
        prev = _SIGMA0 * (k ** (i - 1))
        total = prev * k
        sig.append(math.sqrt(total * total - prev * prev))
    return sig


def octave_quotas(max_kpts: int, noctaves: int):
    """Static per-octave keypoint slots, proportional to octave area."""
    weights = [4.0 ** (-o) for o in range(noctaves)]
    total = sum(weights)
    quotas = [max(int(round(max_kpts * w / total)), 32) for w in weights]
    while sum(quotas) > max_kpts:
        quotas[quotas.index(max(quotas))] -= 1
    return quotas


def _base_sigma(upscale_first: bool) -> float:
    """Blur that takes the (upsampled) input to sigma 1.6: the input is
    assumed blurred by 0.5 px, 1.0 px after the 2x upsample."""
    init = 2 * _INIT_SIGMA if upscale_first else _INIT_SIGMA
    return math.sqrt(max(_SIGMA0 ** 2 - init ** 2, 0.01))


def scale_space(imgs, noctaves: int, upscale_first: bool = True):
    """Gaussian octaves of (F, H, W) frames in [0, 255], the first one
    upsampled 2x (so its pixels are half an input pixel) unless
    `upscale_first` is False: a list of (F, S+3, h, w) stacks, one per
    octave down to 32 px."""
    x = _div(imgs.to(torch.float32), 255.0)
    base = upsample2x(x) if upscale_first else x
    oct_img = blur(base, _base_sigma(upscale_first))
    sig = _level_sigmas()
    octaves = []
    for oh, ow in octave_sizes(*imgs.shape[-2:], noctaves, upscale_first):
        gauss = [oct_img]
        for i in range(1, _S + 3):
            gauss.append(blur(gauss[-1], sig[i]))
        octaves.append(torch.stack(gauss, dim=1))
        # cv2 buildGaussianPyramid: every-2nd-pixel decimation of level S
        oct_img = gauss[_S][:, ::2, ::2][:, :oh // 2, :ow // 2]
    return octaves


def octave_sizes(h: int, w: int, noctaves: int, upscale_first: bool = True):
    """The (h, w) of each octave `scale_space` builds for h x w frames:
    halved (floor) down to 32 px."""
    oh, ow = (2 * h, 2 * w) if upscale_first else (h, w)
    sizes = []
    for _ in range(noctaves):
        if oh < 32 or ow < 32:
            break
        sizes.append((oh, ow))
        oh, ow = oh // 2, ow // 2
    return sizes


def extrema_values(D):
    """|DoG| at strict 26-neighbour extrema (and past the contrast
    pre-threshold), 0 elsewhere: D (F, S+2, H, W) -> (F, 3*H*W), layers
    1..S in order. Built from separable shift-maxes; the roll wrap is
    masked by the border."""
    border = _BORDER
    h, w = D.shape[-2:]
    prethr = 0.5 * 0.04 / _S

    def hshift3(d, red):
        return red(red(torch.roll(d, 1, -1), d), torch.roll(d, -1, -1))

    def full3x3(hm, red):
        return red(red(torch.roll(hm, 1, -2), hm), torch.roll(hm, -1, -2))

    def ring8(d, hm, red):
        return red(red(torch.roll(hm, 1, -2), torch.roll(hm, -1, -2)),
                   red(torch.roll(d, 1, -1), torch.roll(d, -1, -1)))

    hmax = hshift3(D, torch.maximum)
    hmin = hshift3(D, torch.minimum)
    v3max = full3x3(hmax, torch.maximum)
    v3min = full3x3(hmin, torch.minimum)
    ys = torch.arange(h, device=D.device)[:, None]
    xs = torch.arange(w, device=D.device)[None, :]
    bmask = ((ys >= border) & (ys < h - border)
             & (xs >= border) & (xs < w - border))
    vals = []
    for k in range(1, _S + 1):
        d = D[:, k]
        nmax = torch.maximum(ring8(d, hmax[:, k], torch.maximum),
                             torch.maximum(v3max[:, k - 1], v3max[:, k + 1]))
        nmin = torch.minimum(ring8(d, hmin[:, k], torch.minimum),
                             torch.minimum(v3min[:, k - 1], v3min[:, k + 1]))
        is_max = (d > nmax) & (d > prethr)
        is_min = (d < nmin) & (d < -prethr)
        ext = (is_max | is_min) & bmask
        vals.append(torch.where(ext, d.abs(), torch.zeros_like(d)))
    return torch.stack(vals, dim=1).reshape(D.shape[0], -1)


SELECT_MODES = ("exact", "approx", "block2")


def select_candidates(vals, quota: int, select: str = "exact"):
    """The octave's top-`quota` extrema (F, N) -> (scores, flat indices),
    each (F, quota), by the reference's `select` modes: "exact" and
    "approx" (`lax.approx_max_k`, which off the TPU is the exact top-k)
    take the stable top-k of all N; "block2" takes two first-index argmax
    passes per 128-element block, then the stable top-k of the 2 * N / 128
    winners (rpe_tpu/ops/sift.py `_detect_octave`)."""
    if select not in SELECT_MODES:
        raise ValueError(f"select must be one of {SELECT_MODES}, got "
                         f"{select!r}")
    if select != "block2":
        return top_k_stable(vals, quota)
    f, n = vals.shape
    nb = -(-n // 128)
    vpad = F.pad(vals, (0, nb * 128 - n)).reshape(f, nb, 128)
    i1 = torch.argmax(vpad, dim=-1)
    v1 = torch.gather(vpad, -1, i1[..., None])[..., 0]
    vmask = vpad.scatter(-1, i1[..., None], 0.0)
    i2 = torch.argmax(vmask, dim=-1)
    v2 = torch.gather(vmask, -1, i2[..., None])[..., 0]
    base = torch.arange(nb, device=vals.device) * 128
    cv = torch.cat([v1, v2], dim=-1)
    ci = torch.cat([base + i1, base + i2], dim=-1)
    scores, sel = top_k_stable(cv, quota)
    return scores, torch.gather(ci, -1, sel).clamp_max(n - 1)


def _cube_derivs(c):
    """Finite-difference gradient/Hessian of (..., 3, 3, 3) DoG cubes
    indexed [ds, dy, dx] around the centre sample."""
    dx_ = (c[..., 1, 1, 2] - c[..., 1, 1, 0]) * 0.5
    dy_ = (c[..., 1, 2, 1] - c[..., 1, 0, 1]) * 0.5
    ds_ = (c[..., 2, 1, 1] - c[..., 0, 1, 1]) * 0.5
    ctr = c[..., 1, 1, 1]
    dxx = c[..., 1, 1, 2] + c[..., 1, 1, 0] - 2 * ctr
    dyy = c[..., 1, 2, 1] + c[..., 1, 0, 1] - 2 * ctr
    dss = c[..., 2, 1, 1] + c[..., 0, 1, 1] - 2 * ctr
    dxy = (c[..., 1, 2, 2] - c[..., 1, 2, 0] - c[..., 1, 0, 2]
           + c[..., 1, 0, 0]) * 0.25
    dxs = (c[..., 2, 1, 2] - c[..., 2, 1, 0] - c[..., 0, 1, 2]
           + c[..., 0, 1, 0]) * 0.25
    dys = (c[..., 2, 2, 1] - c[..., 2, 0, 1] - c[..., 0, 2, 1]
           + c[..., 0, 0, 1]) * 0.25
    return ctr, (dx_, dy_, ds_), (dxx, dyy, dss, dxy, dxs, dys)


def _solve_offset(g, H):
    """off = -H^-1 g for the symmetric 3x3 Hessian (adjugate closed form)."""
    gx, gy, gs = g
    a, e, i_, b_, c, f = H
    det = (a * (e * i_ - f * f) - b_ * (b_ * i_ - f * c)
           + c * (b_ * f - e * c))
    inv_ok = det.abs() > 1e-12
    det = torch.where(inv_ok, det, torch.ones_like(det))
    A00 = e * i_ - f * f
    A01 = c * f - b_ * i_
    A02 = b_ * f - c * e
    A11 = a * i_ - c * c
    A12 = c * b_ - a * f
    A22 = a * e - b_ * b_
    offx = -(A00 * gx + A01 * gy + A02 * gs) / det
    offy = -(A01 * gx + A11 * gy + A12 * gs) / det
    offs = -(A02 * gx + A12 * gy + A22 * gs) / det
    return offx, offy, offs, inv_ok


def refine_candidates(D, scores0, flat):
    """OpenCV adjustLocalExtrema on the selected candidates: up to 5
    integer relocations of (x, y, layer) while any quadratic offset exceeds
    0.5, dropping points that leave the layer range or the border or do not
    converge; then the contrast and edge checks. D (F, S+2, H, W); scores0,
    flat (F, Q). Returns xy (F, Q, 2) octave coords, layer (F, Q) float,
    score, valid, and the integer layer in [1, S]."""
    border = _BORDER
    f, _, h, w = D.shape
    pix = flat % (h * w)
    kk = flat // (h * w) + 1
    py = pix // w
    px = pix % w
    alive = scores0 > 0.0
    dev = D.device
    Dflat = D.reshape(-1)
    doff = torch.arange(-1, 2, device=dev)
    base = (torch.arange(f, device=dev) * (_S + 2))[:, None, None, None, None]

    def cube_at(kc, yc, xc):
        KK = (kc[..., None, None, None] + doff[:, None, None]).clamp(0, _S + 1)
        YY = (yc[..., None, None, None] + doff[None, :, None]).clamp(0, h - 1)
        XX = (xc[..., None, None, None] + doff[None, None, :]).clamp(0, w - 1)
        return Dflat[((base + KK) * h + YY) * w + XX]

    zeros = torch.zeros_like(scores0)
    offx, offy, offs = zeros, zeros, zeros
    converged = torch.zeros_like(alive)
    for _ in range(_MAX_INTERP_STEPS):
        _, g, H = _cube_derivs(cube_at(kk, py, px))
        ox, oy, os_, inv_ok = _solve_offset(g, H)
        upd = alive & ~converged
        offx = torch.where(upd, ox, offx)
        offy = torch.where(upd, oy, offy)
        offs = torch.where(upd, os_, offs)
        conv_now = (ox.abs() < 0.5) & (oy.abs() < 0.5) & (os_.abs() < 0.5)
        converged = converged | (upd & conv_now)
        move = upd & ~conv_now
        px = torch.where(move, px + torch.round(ox).to(px.dtype), px)
        py = torch.where(move, py + torch.round(oy).to(py.dtype), py)
        kk = torch.where(move, kk + torch.round(os_).to(kk.dtype), kk)
        in_range = ((kk >= 1) & (kk <= _S)
                    & (px >= border) & (px < w - border)
                    & (py >= border) & (py < h - border))
        alive = alive & in_range & inv_ok
    alive = alive & converged

    ctr, g, H = _cube_derivs(cube_at(kk, py, px))
    dxx, dyy, dxy = H[0], H[1], H[3]
    d_hat = ctr + 0.5 * (g[0] * offx + g[1] * offy + g[2] * offs)
    contrast_ok = d_hat.abs() * _S >= 0.04
    tr = dxx + dyy
    det2 = dxx * dyy - dxy * dxy
    edge_ok = (det2 > 0) & (tr * tr * _EDGE_R < (_EDGE_R + 1) ** 2 * det2)
    valid = alive & contrast_ok & edge_ok
    xy = torch.stack([px.to(torch.float32) + offx,
                      py.to(torch.float32) + offy], dim=-1)
    lay = kk.to(torch.float32) + offs
    score = torch.where(valid, d_hat.abs(), zeros)
    return xy, lay, score, valid, kk


def extract_patches(gstack, li, xy, Py: int, Px: int):
    """(Py, Px) patch of each keypoint's own Gaussian layer: gstack
    (F, L, H, W), li (F, Q) layer, xy (F, Q, 2) octave coords. The origin
    is round(xy) - half size clamped into the image. Returns (patches
    (F, Q, Py, Px), x0, y0)."""
    f, nl, h, w = gstack.shape
    dev = gstack.device
    y0 = (torch.round(xy[..., 1]).to(torch.int64) - Py // 2).clamp(0, h - Py)
    x0 = (torch.round(xy[..., 0]).to(torch.int64) - Px // 2).clamp(0, w - Px)
    plane = torch.arange(f, device=dev)[:, None] * nl + li.to(torch.int64)
    start = (plane * h + y0) * w + x0                        # (F, Q)
    flat = gstack.reshape(-1)
    dx = torch.arange(Px, device=dev)
    parts = []
    for r0 in range(0, Py, _PATCH_ROWS):
        dy = torch.arange(r0, min(r0 + _PATCH_ROWS, Py), device=dev)
        idx = start[..., None, None] + (dy * w)[:, None] + dx
        parts.append(flat[idx])
    return torch.cat(parts, dim=2), x0, y0


def _patch_grads(patches):
    """Central differences inside each patch (the roll wrap only touches
    the 1-px rim, which the sample weights keep off)."""
    gx = (torch.roll(patches, -1, -1) - torch.roll(patches, 1, -1)) * 0.5
    gy = (torch.roll(patches, -1, -2) - torch.roll(patches, 1, -2)) * 0.5
    return gx, gy


def _one_hot(idx, n: int, dtype=torch.float32):
    """One-hot by comparison: all zeros where idx is outside [0, n), as
    `jax.nn.one_hot` (torch's one_hot raises there)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _sep_weights(u, P: int):
    """Per-axis bilinear weights (..., G) -> (..., G, P), two nonzeros per
    row; samples clamp to [1, P-2] (off the wrapped-gradient rim)."""
    u = u.clamp(1.0, P - 2.001)
    u0 = torch.floor(u).to(torch.int64)
    f = u - u0.to(torch.float32)
    return (_one_hot(u0, P) * (1 - f)[..., None]
            + _one_hot(u0 + 1, P) * f[..., None])


def _patch_sample(gp, Wy, Wx):
    """Separable bilinear sampling as two batched float32 matmuls:
    gp (..., P, P), Wy (..., Gy, P), Wx (..., Gx, P) -> (..., Gy, Gx)."""
    return torch.matmul(torch.matmul(Wy, gp), Wx.transpose(-1, -2))


@functools.lru_cache(maxsize=None)
def _grid_tables():
    """The orientation and descriptor grids (numpy float32, each step a
    float32 operation as in the reference): orientation lin in [-1, 1]
    and its r^2; descriptor lin in (-1, 1)."""
    f32 = np.float32
    g = _ORI_GRID
    half = f32((g - 1) / 2.0)
    ori_lin = (np.arange(g, dtype=f32) - half) / half
    oy, ox = np.meshgrid(ori_lin, ori_lin, indexing="ij")
    ori_r2 = ox ** 2 + oy ** 2
    g = _DESC_GRID
    desc_lin = (np.arange(g, dtype=f32) + f32(0.5)) / f32(g) * f32(2.0) \
        - f32(1.0)
    return ori_lin, ori_r2, desc_lin


@functools.lru_cache(maxsize=None)
def _grid_weights():
    """Gaussian window weights of the two grids, computed once in torch on
    the CPU so the CPU and CUDA runs of the port share them exactly."""
    ori_lin, ori_r2, desc_lin = (torch.from_numpy(a) for a in _grid_tables())
    ori_w = torch.exp(-4.5 * ori_r2) * (ori_r2 <= 1.0)
    dy, dx = torch.meshgrid(desc_lin, desc_lin, indexing="ij")
    d = _DESC_D
    desc_w = torch.exp(_div(-(dx ** 2 + dy ** 2) * (d + 1) ** 2, d * d))
    return ori_w, desc_w


def _sample_weights(ucx, ucy, lin, radius, Py: int, Px: int):
    """The separable bilinear weights of a keypoint's axis-aligned grid:
    centre (ucx, ucy) (F, Q), grid `lin` (G,) scaled by radius (F, Q) ->
    (Wy (F, Q, G, Py), Wx (F, Q, G, Px))."""
    ux = ucx[..., None] + lin * radius[..., None]
    uy = ucy[..., None] + lin * radius[..., None]
    return _sep_weights(uy, Py), _sep_weights(ux, Px)


def _orientation_weights(ucx, ucy, scl, Py: int, Px: int):
    """The orientation window's bilinear weights (Wy, Wx), radius 4.5 scl."""
    lin = torch.from_numpy(_grid_tables()[0]).to(ucx.device)
    radius = 3.0 * 1.5 * scl
    return _sample_weights(ucx, ucy, lin, radius, Py, Px)


def _orientation_samples(gxp, gyp, ucx, ucy, scl):
    """The orientation window's 24x24 gradient samples (vx, vy), each
    (F, Q, 24, 24), rows y and columns x."""
    Wy, Wx = _orientation_weights(ucx, ucy, scl, *gxp.shape[-2:])
    return _patch_sample(gxp, Wy, Wx), _patch_sample(gyp, Wy, Wx)


def _orientation_terms(vx, vy):
    """Each sample's histogram bin (int64) and its term, the magnitude
    times the Gaussian window (float32), both (F, Q, 24, 24)."""
    ori_w = _grid_weights()[0].to(vx.device)
    mag = torch.sqrt(vx * vx + vy * vy)
    ang = torch.atan2(vy, vx)
    bins = torch.floor((_div(ang, 2 * math.pi) + 0.5) * _ORI_BINS)
    bins = bins.to(torch.int64).clamp(0, _ORI_BINS - 1)
    return bins, mag * ori_w


def _frame_by_frame(fn, *xs, **kw):
    """fn(*xs) one frame (leading index) at a time, the outputs joined.

    On the CPU an elementwise operation splits its range across threads,
    and an element that falls in the scalar tail of a thread's piece is
    computed by the scalar function (std::atan2) instead of the vectorised
    one (SLEEF's), which may differ in the last bit: with several threads
    the split, and so a frame's bits, depended on the number of frames in
    the call. One frame at a time every operation has the same shape
    whatever that number (with one thread the same bits as the whole
    batch at once)."""
    if xs[0].shape[0] <= 1:
        return fn(*xs, **kw)
    outs = [fn(*(x[f:f + 1] for x in xs), **kw)
            for f in range(xs[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def orientation_hist_plain(gxp, gyp, ucx, ucy, scl, detail: bool = False):
    """Plain version of P3: the 36-bin orientation histogram (F, Q, 36) of
    each keypoint before smoothing, from gxp/gyp (F, Q, Py, Px) in-patch
    gradients of the keypoint's layer, ucx/ucy (F, Q) in-patch centre and
    scl (F, Q) octave-coordinate scale. The sum over the 576 samples is a
    float32 matmul against the bins' one-hot; frame by frame, so a
    frame's bits do not depend on the batch (`_frame_by_frame`). With
    `detail`, also the samples vx, vy (F, Q, 24, 24) and the bins
    (F, Q, 576) uint8."""
    return _frame_by_frame(_orientation_hist_frames, gxp, gyp, ucx, ucy, scl,
                           detail=detail)


def _orientation_hist_frames(gxp, gyp, ucx, ucy, scl, detail: bool):
    vx, vy = _orientation_samples(gxp, gyp, ucx, ucy, scl)
    bins, w = _orientation_terms(vx, vy)
    lead = w.shape[:-2]
    onehot = _one_hot(bins, _ORI_BINS).reshape(*lead, -1, _ORI_BINS)
    hist = torch.matmul(w.reshape(*lead, 1, -1), onehot)[..., 0, :]
    if detail:
        return hist, vx, vy, bins.reshape(*lead, -1).to(torch.uint8)
    return hist


def orientation_hist(gxp, gyp, ucx, ucy, scl, detail: bool = False):
    """P3: `orientation_hist_plain`'s histogram, each bin summed over the
    samples in ascending order whatever the batch. CUDA tensors launch
    csrc/sift_sample.cu; CPU tensors take the plain version. With
    `detail`, also the kernel's samples and bins, as the plain version's
    detail."""
    if gxp.device.type == "cpu":
        return orientation_hist_plain(gxp, gyp, ucx, ucy, scl, detail)
    f, q, py, px = gxp.shape
    gxp, gyp, ucx, ucy, scl = _kernel_inputs(
        "sift_orientation_hist", (f, q, py, px), (f, q), gxp=gxp, gyp=gyp,
        ucx=ucx, ucy=ucy, scl=scl)
    dev = gxp.device
    hist = torch.empty((f, q, _ORI_BINS), dtype=torch.float32, device=dev)
    samples, bins = _detail_outputs(detail, f, q, dev, torch.uint8,
                                    _ORI_GRID * _ORI_GRID)
    kernels.launch("sift_orientation_hist",
                   _launchers(kernels.lib("sift_sample"))[0], gxp,
                   *map(_ptr, (gxp, gyp, ucx, ucy, scl, _device_tables(dev),
                               hist, samples, bins)), f * q, py, px)
    if detail:
        return hist, samples[:, :, 0], samples[:, :, 1], bins
    return hist


def orientation_peaks(hist, valid):
    """Dominant orientation and an optional second one per keypoint from
    its raw histogram (F, Q, 36): [1,4,6,4,1] circular smoothing, then
    (theta1, theta2, has2): has2 where a second local peak of the smoothed
    histogram reaches 0.8 of the maximum (OpenCV SIFT_ORI_PEAK_RATIO)."""
    dev = hist.device
    hist = (torch.roll(hist, 2, -1) + 4 * torch.roll(hist, 1, -1) + 6 * hist
            + 4 * torch.roll(hist, -1, -1) + torch.roll(hist, -2, -1)) / 16.0

    def peak_theta(peak):
        hp = torch.gather(hist, -1, peak[..., None])[..., 0]
        hl = torch.gather(hist, -1, ((peak - 1) % _ORI_BINS)[..., None])[..., 0]
        hr = torch.gather(hist, -1, ((peak + 1) % _ORI_BINS)[..., None])[..., 0]
        denom = hl - 2 * hp + hr
        safe = denom.abs() > 1e-12
        interp = torch.where(
            safe, 0.5 * (hl - hr) / torch.where(safe, denom,
                                                torch.ones_like(denom)),
            torch.zeros_like(denom))
        bin_f = peak.to(torch.float32) + interp
        return _div(bin_f + 0.5, _ORI_BINS) * 2 * math.pi - math.pi, hp

    peak1 = torch.argmax(hist, dim=-1)
    theta1, h1 = peak_theta(peak1)
    is_local = ((hist > torch.roll(hist, 1, -1))
                & (hist > torch.roll(hist, -1, -1)))
    not_primary = (torch.arange(_ORI_BINS, device=dev) != peak1[..., None])
    cand = torch.where(is_local & not_primary, hist,
                       torch.full_like(hist, -torch.inf))
    peak2 = torch.argmax(cand, dim=-1)
    theta2, h2 = peak_theta(peak2)
    has2 = valid & (h2 >= 0.8 * h1) & torch.isfinite(
        torch.gather(cand, -1, peak2[..., None])[..., 0])
    return theta1, theta2, has2


def _tri(binf, n: int, wrap: bool):
    """Linear-interpolation one-hots over n bins: (...,) -> (..., n);
    out-of-range bins drop (wrap=False) or wrap around (wrap=True)."""
    b0 = torch.floor(binf)
    f = binf - b0
    b0i = b0.to(torch.int64)
    b1i = b0i + 1
    if wrap:
        b0i = torch.remainder(b0i, n)
        b1i = torch.remainder(b1i, n)
        m0 = m1 = torch.ones_like(f)
    else:
        m0 = ((b0i >= 0) & (b0i < n)).to(f.dtype)
        m1 = ((b1i >= 0) & (b1i < n)).to(f.dtype)
        b0i = b0i.clamp(0, n - 1)
        b1i = b1i.clamp(0, n - 1)
    return (_one_hot(b0i, n) * ((1 - f) * m0)[..., None]
            + _one_hot(b1i, n) * (f * m1)[..., None])


def _normalise(desc):
    """Normalise -> clip at 0.2 -> renormalise, along the last axis."""
    nrm = torch.sqrt((desc * desc).sum(-1, keepdim=True)) + 1e-12
    desc = torch.clamp_max(desc / nrm, 0.2)
    nrm2 = torch.sqrt((desc * desc).sum(-1, keepdim=True)) + 1e-12
    return desc / nrm2


def descriptor_plain(gxp, gyp, ucx, ucy, scl, theta, detail: bool = False):
    """Plain version of P4: the 4x4x8 SIFT descriptor per keypoint from an
    axis-aligned sample grid with rotated bin coordinates (the grid spans
    the rotated window's circumradius; samples outside the bins are masked
    as cv2 discards them). gxp/gyp (F, Q, Py, Px) the keypoint's own
    patch gradients; ucx, ucy, scl, theta (F, Q). Returns (F, Q, 128)
    float32, unit norm after clipping at 0.2; with `detail`, also the
    samples vx, vy (F, Q, 24, 24) and the 128 sums before normalising.
    Frame by frame, so a frame's bits do not depend on the batch
    (`_frame_by_frame`)."""
    return _frame_by_frame(_descriptor_frames, gxp, gyp, ucx, ucy, scl,
                           theta, detail=detail)


def _descriptor_frames(gxp, gyp, ucx, ucy, scl, theta, detail: bool):
    Py, Px = gxp.shape[-2:]
    dev = gxp.device
    g, d = _DESC_GRID, _DESC_D
    lin = torch.from_numpy(_grid_tables()[2]).to(dev)
    desc_w = _grid_weights()[1].to(dev)
    gy_, gx_ = torch.meshgrid(lin, lin, indexing="ij")
    hist_width = 3.0 * scl
    radius = hist_width * math.sqrt(2.0) * (d + 1) * 0.5
    Wy, Wx = _sample_weights(ucx, ucy, lin, radius, Py, Px)
    vx = _patch_sample(gxp, Wy, Wx)
    vy = _patch_sample(gyp, Wy, Wx)
    mag = torch.sqrt(vx * vx + vy * vy)
    ang = torch.atan2(vy, vx) - theta[..., None, None]

    ca = torch.cos(theta)[..., None, None]
    sa = torch.sin(theta)[..., None, None]
    gxr = gx_ * ca + gy_ * sa
    gyr = -gx_ * sa + gy_ * ca
    rbin = gyr * math.sqrt(2.0) * (d + 1) * 0.5 + d / 2.0 - 0.5
    cbin = gxr * math.sqrt(2.0) * (d + 1) * 0.5 + d / 2.0 - 0.5
    # cv2's descriptor gradients are y-up: negate the relative angle
    obin = _div(-ang, 2 * math.pi) * _DESC_B
    obin = torch.remainder(obin, _DESC_B)
    w = mag * desc_w

    lead = mag.shape[:-2]
    R = _tri(rbin, d, wrap=False)
    C = _tri(cbin, d, wrap=False)
    O = _tri(obin, _DESC_B, wrap=True)
    RC = (R[..., :, None] * C[..., None, :]).reshape(*lead, g * g, d * d)
    wO = (w[..., None] * O).reshape(*lead, g * g, _DESC_B)
    raw = torch.matmul(RC.transpose(-1, -2), wO).reshape(*lead, d * d * _DESC_B)
    if detail:
        return _normalise(raw), vx, vy, raw
    return _normalise(raw)


def descriptor(gxp, gyp, pidx, ucx, ucy, scl, theta, detail: bool = False):
    """P4: `descriptor_plain` of the patches gxp/gyp (F, Q0, Py, Px) picked
    by pidx (F, Q) for the keypoints ucx, ucy, scl, theta (F, Q), every
    sum in an order that does not depend on the batch. CUDA tensors
    launch csrc/sift_sample.cu, which reads the patches through pidx
    (in [0, Q0), unchecked); CPU tensors gather them and take the plain
    version."""
    if gxp.device.type == "cpu":
        return descriptor_plain(_take(gxp, pidx), _take(gyp, pidx), ucx, ucy,
                                scl, theta, detail)
    f, q0, py, px = gxp.shape
    q = pidx.shape[-1]
    gxp, gyp, ucx, ucy, scl, theta = _kernel_inputs(
        "sift_descriptor", (f, q0, py, px), (f, q), gxp=gxp, gyp=gyp,
        ucx=ucx, ucy=ucy, scl=scl, theta=theta)
    if pidx.shape != (f, q) or pidx.dtype != torch.int64 \
            or pidx.device != gxp.device:
        raise ValueError(f"sift_descriptor: pidx must be ({f}, {q}) int64 "
                         f"on {gxp.device}")
    pidx = pidx.contiguous()
    dev = gxp.device
    desc = torch.empty((f, q, _DESC_D * _DESC_D * _DESC_B),
                       dtype=torch.float32, device=dev)
    samples, raw = _detail_outputs(detail, f, q, dev, torch.float32,
                                   _DESC_D * _DESC_D * _DESC_B)
    kernels.launch("sift_descriptor",
                   _launchers(kernels.lib("sift_sample"))[1], gxp,
                   *map(_ptr, (gxp, gyp, pidx, ucx, ucy, scl, theta,
                               _device_tables(dev), desc, samples, raw)),
                   f * q, q, q0, py, px)
    if detail:
        return desc, samples[:, :, 0], samples[:, :, 1], raw
    return desc


def _ptr(t):
    return None if t is None else t.data_ptr()


def _kernel_inputs(name, patch_shape, slot_shape, **tensors):
    """P3's and P4's float32 inputs on one CUDA device, contiguous: the
    patches of `patch_shape` (F, Q, Py, Px; the kernels' bilinear taps
    need Py, Px >= 4) and the per-slot values of `slot_shape`."""
    out = []
    for k, t in tensors.items():
        want = patch_shape if k in ("gxp", "gyp") else slot_shape
        if t.dtype != torch.float32 or tuple(t.shape) != want:
            raise ValueError(f"{name}: {k} must be {want} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        out.append(t.contiguous())
    if min(patch_shape[2:]) < 4:
        raise ValueError(f"{name}: patches of {patch_shape[2:]}, the "
                         f"bilinear taps need at least 4 x 4")
    kernels.require_cuda(name, **dict(zip(tensors, out)))
    return out


def _detail_outputs(detail, f, q, dev, dtype, n):
    """The kernels' optional outputs: samples (F, Q, 2, 24, 24) float32 and
    (F, Q, n) of `dtype` (P3's bins, P4's sums before normalising)."""
    if not detail:
        return None, None
    g = _ORI_GRID
    return (torch.empty((f, q, 2, g, g), dtype=torch.float32, device=dev),
            torch.empty((f, q, n), dtype=dtype, device=dev))


@functools.lru_cache(maxsize=None)
def _device_tables(device):
    """P3's and P4's grid tables on the card, copied there once per device
    (a tensor's device, so one with its index): the orientation grid and
    its window, the descriptor grid and its window, float32."""
    ori_lin, _, desc_lin = _grid_tables()
    ori_w, desc_w = _grid_weights()
    return htod(torch.cat([torch.from_numpy(ori_lin), ori_w.reshape(-1),
                           torch.from_numpy(desc_lin),
                           desc_w.reshape(-1)]), device)


@functools.lru_cache(maxsize=None)
def _launchers(lib):
    """P3's and P4's launchers with their argument types set, once per
    loaded library, after holding the kernel's grid to this module's."""
    g = _ORI_GRID
    if not (lib.sift_sample_grid() == g == _DESC_GRID
            and lib.sift_sample_table_len() == 2 * g + 2 * g * g):
        raise RuntimeError("sift_sample.cu's grid disagrees with ops/sift.py")
    ori = lib.sift_orientation_hist_launch
    ori.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_int, ctypes.c_void_p]
    ori.restype = ctypes.c_int
    desc = lib.sift_descriptor_launch
    desc.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    desc.restype = ctypes.c_int
    return ori, desc


def _take(x, idx):
    """x (F, N, ...) gathered along axis 1 by idx (F, M)."""
    ix = idx.reshape(*idx.shape, *([1] * (x.dim() - 2)))
    return torch.gather(x, 1, ix.expand(*idx.shape, *x.shape[2:]))


def keypoint_patches(G, xy, lay, valid, kint):
    """Each refined keypoint's patch gradients on its own Gaussian layer
    (1..S) of octave stack G (F, S+3, h, w): an 80-px patch covers the
    largest descriptor window (radius ~38.5 px). Invalid slots move to
    (16, 16). Returns (xy, scl, ucx, ucy, gxp, gyp): xy (F, Q, 2) octave
    coords, scl (F, Q) octave-coordinate scale, ucx/ucy (F, Q) in-patch
    centre, gxp/gyp (F, Q, Py, Px)."""
    oh, ow = G.shape[-2:]
    xy = torch.where(valid[..., None], xy, torch.full_like(xy, 16.0))
    scl = _SIGMA0 * torch.pow(2.0, _div(lay, _S))
    li = (kint - 1).clamp(0, _S - 1)
    Py, Px = min(80, oh), min(80, ow)
    patches, px0, py0 = extract_patches(G[:, 1:_S + 1], li, xy, Py, Px)
    ucx = xy[..., 0] - px0.to(torch.float32)
    ucy = xy[..., 1] - py0.to(torch.float32)
    gxp, gyp = _patch_grads(patches)
    return xy, scl, ucx, ucy, gxp, gyp


def reselect(scores, valid, theta1, theta2, has2):
    """Secondary orientations become extra keypoints; the octave's quota
    Q is re-selected by score, primaries winning ties by a haircut.
    Returns (score (F, Q), pidx: each slot's source keypoint (F, Q),
    theta (F, Q))."""
    q0 = scores.shape[1]
    score2 = torch.cat([scores, torch.where(
        has2, scores * (1.0 - 1e-6), torch.zeros_like(scores))], dim=1)
    valid2 = torch.cat([valid, has2], dim=1)
    sel_score, sel = top_k_stable(
        torch.where(valid2, score2, torch.zeros_like(score2)), q0)
    theta = torch.gather(torch.cat([theta1, theta2], dim=1), 1, sel)
    return sel_score, sel % q0, theta


def sift_detect_and_describe(imgs, cfg: SiftConfig = SiftConfig(),
                             upscale_first: bool = True,
                             select: str = "exact"):
    """SIFT on a batch of grayscale frames (F, H, W) float32 in [0, 255],
    with the reference's options: the first octave upsampled 2x unless
    `upscale_first` is False, the extrema quota picked by `select`
    (`select_candidates`).

    Returns dict of (F, max_kpts, ...) arrays: xy (2) float32 level-0 pixel
    coords, angle float32 radians, level int32 octave, score float32,
    desc (128) float32, valid bool."""
    octaves = scale_space(imgs, cfg.noctaves, upscale_first)
    quotas = octave_quotas(cfg.max_kpts, cfg.noctaves)
    base_scale = 0.5 if upscale_first else 1.0
    outs = []
    for o, G in enumerate(octaves):
        f = G.shape[0]
        D = G[:, 1:] - G[:, :-1]                              # (F, S+2, h, w)
        scores0, flat = select_candidates(extrema_values(D), quotas[o],
                                          select)
        xy, lay, scores, valid, kint = refine_candidates(D, scores0, flat)
        xy, scl, ucx, ucy, gxp, gyp = keypoint_patches(G, xy, lay, valid,
                                                       kint)
        hist = orientation_hist(gxp, gyp, ucx, ucy, scl)
        theta1, theta2, has2 = orientation_peaks(hist, valid)
        sel_score, pidx, theta = reselect(scores, valid, theta1, theta2,
                                          has2)
        scl = torch.gather(scl, 1, pidx)
        desc = descriptor(gxp, gyp, pidx, torch.gather(ucx, 1, pidx),
                          torch.gather(ucy, 1, pidx), scl, theta)
        outs.append({
            "xy": _take(xy, pidx) * (base_scale * (2.0 ** o)),
            "angle": theta,
            "level": torch.full(pidx.shape, o, dtype=torch.int32,
                                device=imgs.device),
            "score": sel_score,
            "desc": desc,
            "valid": sel_score > 0.0,
        })

    res = {k: torch.cat([u[k] for u in outs], dim=1) for k in outs[0]}
    n = res["xy"].shape[1]
    if n < cfg.max_kpts:
        pad = cfg.max_kpts - n
        res = {k: F.pad(v, (0, 0, 0, pad)) if v.dim() == 3
               else F.pad(v, (0, pad)) for k, v in res.items()}
    else:
        res = {k: v[:, :cfg.max_kpts] for k, v in res.items()}
    return res
