"""Line-segment detection for the vanishing-point refinement (port of
rpe_tpu/ops/lsd.py).

The reference replaces OpenCV's sequential seed-and-grow LSD with parallel
label propagation:

  1. 2x2 LSD gradient masks -> magnitude + level-line angle per pixel;
  2. pixels above the LSD gradient threshold take part;
  3. PROP_ITERS rounds of orientation-gated 8-neighbour max-propagation
     spread a unique label (the flat pixel index) over pixels whose
     level-line angles agree within 22.5 deg;
  4. per-component PCA gives endpoints, length and width; thin elongated
     components become segments.

`_label_regions` runs steps 1-3 on a stack of frames at once (the reference
maps it over frames). The shifts wrap around the image edges, as the
reference's `jnp.roll` does. The angle gates do not change between rounds,
so they are computed once; each round is then a roll, a masked fill and a
maximum per neighbour. `segments_from_labels` (step 4 on the host, float64
numpy) is the reference's, verbatim. `detect_line_segments_device` is the
static-shape twin of step 4: scatter reductions keyed by label, the
`max_segments` largest bins (lowest label first among equal counts, as
`lax.top_k`), PCA endpoints, in float32 on the frames' device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..utils.device import resolve_device
from .orb import top_k_stable

ANGLE_TOL_DEG = 22.5
# LSD: threshold = q / sin(tol) with q = 2 (quantization error bound)
GRAD_THRESHOLD = 2.0 / np.sin(np.deg2rad(ANGLE_TOL_DEG))
MIN_REGION = 20        # minimum support pixels for a segment
MIN_ASPECT = 2.0       # length/width elongation requirement
PROP_ITERS = 96        # max propagation distance (px) along a region

_SHIFTS = [(-1, -1), (-1, 0), (-1, 1), (0, -1),
           (0, 1), (1, -1), (1, 0), (1, 1)]


def _angdiff_ok(a, b):
    """Level-line angles agree within the tolerance (orientation-like
    modulo pi), in float32 as the reference compares them."""
    tol = float(np.float32(np.deg2rad(ANGLE_TOL_DEG)))
    d = torch.abs(a - b)
    d = torch.minimum(d, math.pi * 2 - d)
    d = torch.minimum(d, torch.abs(d - math.pi))
    return d < tol


def _label_regions(gray, iters: int = PROP_ITERS):
    """Dense gradient field + orientation-gated label propagation.

    gray: (..., H, W) float tensor. Returns (labels (..., H, W) int32, -1
    outside regions and otherwise the flat index y * W + x of the region's
    largest pixel; angle (..., H, W) float32 level-line angle; mag float32).
    """
    g = gray.to(torch.float32)
    h, w = g.shape[-2:]
    # LSD 2x2 masks at (x, y): pixels (x,y),(x+1,y),(x,y+1),(x+1,y+1), the
    # last row and column repeated past the edge
    s = torch.cat([g, g[..., -1:, :]], dim=-2)
    s = torch.cat([s, s[..., :, -1:]], dim=-1)
    gx = (s[..., :-1, 1:] + s[..., 1:, 1:] - s[..., :-1, :-1]
          - s[..., 1:, :-1]) * 0.5
    gy = (s[..., 1:, :-1] + s[..., 1:, 1:] - s[..., :-1, :-1]
          - s[..., :-1, 1:]) * 0.5
    mag = torch.sqrt(gx * gx + gy * gy)
    # level-line angle (direction along the edge): atan2(gx, -gy)
    ang = torch.atan2(gx, -gy)

    mask = mag > float(np.float32(GRAD_THRESHOLD))
    flat = torch.arange(h * w, dtype=torch.int32,
                        device=g.device).reshape(h, w)
    labels = torch.where(mask, flat, -1)

    dims = (-2, -1)
    # a neighbour's label may enter where this pixel takes part and the
    # two angles agree; these gates hold for every round
    shut = [~(mask & _angdiff_ok(ang, torch.roll(ang, sh, dims)))
            for sh in _SHIFTS]
    for _ in range(iters):
        out = labels.clone()
        for sh, closed in zip(_SHIFTS, shut):
            nl = torch.roll(labels, sh, dims).masked_fill_(closed, -1)
            torch.maximum(out, nl, out=out)
        labels = out
    return labels, ang, mag


def label_regions_host(frames, device=None):
    """Labels and magnitudes of a frame stack (F, H, W) as numpy, computed
    on `device` (the card unless the caller asks for the CPU) with one
    device-to-host copy of each."""
    dev = resolve_device(device)
    labels, _, mag = _label_regions(
        torch.as_tensor(np.asarray(frames, dtype=np.float32), device=dev))
    return labels.cpu().numpy(), mag.cpu().numpy()


def detect_line_segments(gray, min_region: int = MIN_REGION,
                         min_aspect: float = MIN_ASPECT,
                         device=None) -> np.ndarray:
    """Detect line segments; returns (N, 4) float64 [x1, y1, x2, y2], a
    (0, 4) array when nothing is found. The labeling runs on `device`."""
    labels, mag = label_regions_host(np.asarray(gray)[None], device)
    return segments_from_labels(labels[0], mag[0], min_region, min_aspect)


def detect_line_segments_device(gray, max_segments: int = 256,
                                min_region: int = MIN_REGION,
                                min_aspect: float = MIN_ASPECT):
    """Tensor twin of `detect_line_segments`, on the frames' device.

    gray: (H, W) or (F, H, W) float tensor. Returns (segs (..., M, 4)
    float32, valid (..., M) bool) with M = max_segments. Per-component
    statistics are scatter reductions keyed by the propagated label.
    Components are the `max_segments` largest label bins by pixel count;
    the host twin keeps every bin, so frames with more supported regions
    lose the smallest ones here.
    """
    batched = gray.dim() == 3
    g = gray if batched else gray[None]
    labels, _, mag = _label_regions(g)
    nf, h, w = labels.shape
    hw = h * w
    dev = labels.device

    maskpix = labels >= 0
    # sentinel bin hw swallows non-region pixels; each frame owns hw + 1
    # bins of the flat scatter targets
    idx = torch.where(maskpix, labels, hw).reshape(nf, hw).to(torch.int64)
    gidx = (idx + torch.arange(nf, device=dev)[:, None] * (hw + 1)) \
        .reshape(-1)
    wgt = torch.where(maskpix, mag, 0.0).reshape(nf, hw)
    x = torch.arange(w, dtype=torch.float32, device=dev).repeat(h)
    y = torch.arange(h, dtype=torch.float32,
                     device=dev).repeat_interleave(w)

    def scat(vals):
        return torch.zeros(nf * (hw + 1), dtype=torch.float32, device=dev) \
            .index_add_(0, gidx, vals.reshape(-1)).reshape(nf, hw + 1)

    def at(v):
        return torch.gather(v, 1, idx)

    cnt = scat(maskpix.to(torch.float32))
    sw = scat(wgt)
    swx = scat(wgt * x)
    swy = scat(wgt * y)
    sw_safe = torch.clamp_min(sw, 1e-12)
    cx = swx / sw_safe
    cy = swy / sw_safe

    dxp = x - at(cx)
    dyp = y - at(cy)
    sxx = scat(wgt * dxp * dxp) / sw_safe
    syy = scat(wgt * dyp * dyp) / sw_safe
    sxy = scat(wgt * dxp * dyp) / sw_safe

    # principal axis of the 2x2 covariance per bin (closed form, as host)
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    disc = torch.sqrt(torch.clamp_min(tr * tr / 4.0 - det, 0.0))
    l2 = tr / 2.0 - disc                        # minor eigenvalue
    theta = 0.5 * torch.atan2(2.0 * sxy, sxx - syy)
    ux = torch.cos(theta)
    uy = torch.sin(theta)

    # extent along the principal axis -> endpoints (second pass)
    t = dxp * at(ux) + dyp * at(uy)
    big = float(np.float32(3.4e38))
    pix = maskpix.reshape(nf, hw)
    tmin = torch.full((nf * (hw + 1),), big, dtype=torch.float32,
                      device=dev).scatter_reduce_(
        0, gidx, torch.where(pix, t, big).reshape(-1), "amin") \
        .reshape(nf, hw + 1)
    tmax = torch.full((nf * (hw + 1),), -big, dtype=torch.float32,
                      device=dev).scatter_reduce_(
        0, gidx, torch.where(pix, t, -big).reshape(-1), "amax") \
        .reshape(nf, hw + 1)

    # the max_segments most-supported bins (bin id == label value)
    top_cnt, top = top_k_stable(cnt[:, :hw], max_segments)

    def sel(v):
        return torch.gather(v, 1, top)

    tmin_t, tmax_t = sel(tmin), sel(tmax)
    length = tmax_t - tmin_t
    width = 4.0 * torch.sqrt(torch.clamp_min(sel(l2), 1e-12))
    valid = ((top_cnt >= min_region)
             & (length >= min_region * 0.5)
             & (length / torch.clamp_min(width, 1.0) >= min_aspect))

    cxg, cyg = sel(cx), sel(cy)
    uxg, uyg = sel(ux), sel(uy)
    segs = torch.stack([cxg + tmin_t * uxg, cyg + tmin_t * uyg,
                        cxg + tmax_t * uxg, cyg + tmax_t * uyg], dim=-1)
    segs = torch.where(valid[..., None], segs, 0.0)
    if not batched:
        return segs[0], valid[0]
    return segs, valid


def segments_from_labels(labels, mag_np, min_region: int = MIN_REGION,
                         min_aspect: float = MIN_ASPECT) -> np.ndarray:
    """Per-component PCA -> segments from a precomputed label/mag field
    (float64 numpy; the reference's code).

    Split out so batched callers (geometry/vp_refine.py
    manhattan_dirs_for_frames) can run the labeling pass for a whole frame
    stack in one call and feed each frame's result here.
    """
    ys, xs = np.nonzero(labels >= 0)
    if ys.size == 0:
        return np.zeros((0, 4), dtype=np.float64)
    lab = labels[ys, xs]
    wgt = mag_np[ys, xs].astype(np.float64)

    # Compact label ids, then vectorized per-component moments
    uniq, inv, counts = np.unique(lab, return_inverse=True, return_counts=True)
    keep = counts >= min_region
    if not keep.any():
        return np.zeros((0, 4), dtype=np.float64)

    n = uniq.size
    x = xs.astype(np.float64)
    y = ys.astype(np.float64)
    sw = np.bincount(inv, weights=wgt, minlength=n)
    swx = np.bincount(inv, weights=wgt * x, minlength=n)
    swy = np.bincount(inv, weights=wgt * y, minlength=n)
    cx = swx / sw
    cy = swy / sw
    dx = x - cx[inv]
    dy = y - cy[inv]
    sxx = np.bincount(inv, weights=wgt * dx * dx, minlength=n) / sw
    syy = np.bincount(inv, weights=wgt * dy * dy, minlength=n) / sw
    sxy = np.bincount(inv, weights=wgt * dx * dy, minlength=n) / sw

    # principal axis of the 2x2 covariance (closed form)
    tr = sxx + syy
    det = sxx * syy - sxy * sxy
    disc = np.sqrt(np.maximum(tr * tr / 4.0 - det, 0.0))
    l1 = tr / 2.0 + disc      # major eigenvalue
    l2 = tr / 2.0 - disc      # minor eigenvalue
    theta = 0.5 * np.arctan2(2.0 * sxy, sxx - syy)
    ux, uy = np.cos(theta), np.sin(theta)

    # extent along the principal axis -> endpoints
    t = dx * ux[inv] + dy * uy[inv]
    tmin = np.full(n, np.inf)
    tmax = np.full(n, -np.inf)
    np.minimum.at(tmin, inv, t)
    np.maximum.at(tmax, inv, t)

    length = tmax - tmin
    width = 2.0 * np.sqrt(np.maximum(l2, 1e-12)) * 2.0  # ~2 sigma each side
    ok = keep & (length >= min_region * 0.5) & (length / np.maximum(width, 1.0)
                                                >= min_aspect)
    if not ok.any():
        return np.zeros((0, 4), dtype=np.float64)

    x1 = cx + tmin * ux
    y1 = cy + tmin * uy
    x2 = cx + tmax * ux
    y2 = cy + tmax * uy
    segs = np.stack([x1, y1, x2, y2], axis=1)[ok]
    return segs.astype(np.float64)
