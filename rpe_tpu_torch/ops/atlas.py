"""Pyramid atlas: all scale levels packed into one padded image
(port of rpe_tpu/ops/atlas.py).

The levels are stacked vertically with dead gaps >= the patch radius, so the
FAST/Harris rank kernel, the Gaussian blur and the descriptor extraction each
run once per image over the whole pyramid. Every function takes a leading
frame axis: the port batches frames where the reference mapped over them.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.observability import htod
from .pyramid import level_shapes

GAP = 24  # dead rows between levels (> patch radius + blur radius)


@functools.lru_cache(maxsize=None)
def atlas_layout(h: int, w: int, nlevels: int, scale_factor: float):
    """Static layout: per-level (row_offset, h_l, w_l), total rows, padded W."""
    shapes = level_shapes(h, w, nlevels, scale_factor)
    offsets = []
    row = GAP
    for (lh, lw) in shapes:
        offsets.append((row, lh, lw))
        row += lh + GAP
    wp = -(-w // 128) * 128
    # total divisible by 32 with >= 48 dead rows at the bottom, so banded
    # extraction windows stay in bounds for every band width (8/16/32)
    total = -(-row // 32) * 32 + 64
    return tuple(offsets), total, wp


def build_atlas(levels, h: int, w: int, nlevels: int, scale_factor: float):
    """Stack pyramid levels (F, h_l, w_l) (ops/pyramid.py `build_pyramid`)
    into the atlas at `atlas_layout`'s offsets, zeros elsewhere; returns
    (atlas (F, HA, WP), layout)."""
    offsets, total, wp = atlas_layout(h, w, nlevels, scale_factor)
    lvl0 = levels[0]
    atlas = torch.zeros((lvl0.shape[0], total, wp), dtype=lvl0.dtype,
                        device=lvl0.device)
    for lvl, (off, lh, lw) in zip(levels, offsets):
        atlas[:, off:off + lh, :lw] = lvl
    return atlas, (offsets, total, wp)


def _linear_resize_matrix(n_out: int, n_in: int):
    """(n_out, n_in) numpy f32 weights of jax.image.resize method='linear'
    along one axis: half-pixel centers, triangle kernel dilated by the zoom
    factor when minifying (anti-aliased), edge weights renormalized."""
    scale = n_out / n_in
    x = (np.arange(n_out, dtype=np.float64) + 0.5) / scale - 0.5
    kscale = min(scale, 1.0)
    u = (np.arange(n_in, dtype=np.float64)[None, :] - x[:, None]) * kscale
    wts = np.maximum(0.0, 1.0 - np.abs(u))
    s = wts.sum(axis=1, keepdims=True)
    return np.where(s > 0, wts / s, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _atlas_resize_mats(h: int, w: int, nlevels: int, scale_factor: float):
    """Static resize operators (numpy): Rv (sum lh_{l>=1}, h) stacks every
    level>=1's vertical weights; Cws[l-1] is (w, lw_l)."""
    shapes = level_shapes(h, w, nlevels, scale_factor)
    if len(shapes) == 1:
        return np.zeros((0, h), np.float32), ()
    Rv = np.concatenate(
        [_linear_resize_matrix(lh, h) for (lh, _) in shapes[1:]], axis=0)
    Cws = tuple(_linear_resize_matrix(lw, w).T.copy()
                for (_, lw) in shapes[1:])
    return Rv, Cws


def build_atlas_fused(img, nlevels: int, scale_factor: float):
    """Pyramid + atlas: one stacked vertical resampling matmul for all levels
    >= 1, one horizontal matmul per level, one concatenation in layout order.

    img: (F, H, W) float32. Returns (atlas (F, HA, WP), layout). Values
    differ from a per-level resize by matmul reassociation only (~1e-4 on
    [0, 255] data).
    """
    f, h, w = img.shape
    offsets, total, wp = atlas_layout(h, w, nlevels, scale_factor)
    Rv_np, Cws_np = _atlas_resize_mats(h, w, nlevels, scale_factor)
    dev, dt = img.device, img.dtype
    v = torch.matmul(htod(Rv_np, dev), img)                  # (F, sum lh, W)

    def padw(a):
        return torch.nn.functional.pad(a, (0, wp - a.shape[-1]))

    segs = []
    row = 0
    vrow = 0
    for l, (off, lh, lw) in enumerate(offsets):
        segs.append(torch.zeros((f, off - row, wp), dtype=dt, device=dev))
        if l == 0:
            segs.append(padw(img))
        else:
            blk = v[:, vrow:vrow + lh]
            segs.append(padw(torch.matmul(
                blk, htod(Cws_np[l - 1], dev))))
            vrow += lh
        row = off + lh
    segs.append(torch.zeros((f, total - row, wp), dtype=dt, device=dev))
    return torch.cat(segs, dim=1), (offsets, total, wp)


def gaussian_weights(ksize: int = 7, sigma: float = 2.0):
    """Normalized 1-D Gaussian taps as Python floats (float64)."""
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return [float(v) for v in k / k.sum()]


def gaussian_blur_rolled(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur as shifted adds over the last two axes; edges
    wrap (safe on the atlas: keypoints sit >= EDGE_MARGIN from level borders
    and levels are separated by GAP dead rows)."""
    r = ksize // 2
    k = gaussian_weights(ksize, sigma)
    out = torch.zeros_like(img)
    for i in range(ksize):
        out = out + k[i] * torch.roll(img, r - i, dims=-2)
    out2 = torch.zeros_like(out)
    for i in range(ksize):
        out2 = out2 + k[i] * torch.roll(out, r - i, dims=-1)
    return out2


# Default banding geometry (OrbConfig.band/extract_cap override it).
BAND = 8         # default keypoint-center rows per band
CAP = 24         # default max keypoints per 8-row band (scales with band)


def band_tables(ha: int, wp: int, xy, valid, patch: int = 31,
                cap: int | None = None, band: int | None = None):
    """Bucket keypoints into (NB, CAP) extraction slots by y-band.

    xy: (F, K, 2) float atlas coords (integer-valued); valid: (F, K) bool.
    Semantics of the table half of rpe_tpu/ops/atlas.py `banded_extract`:
    a stable sort by band, slots by position within the band run, keypoints
    beyond a band's `cap` dropped (routed to an out-of-bounds sentinel, so
    they never clobber a live slot), parked slots marked rel_y = -31.

    Returns dict with tbl_x0, rel_y (F, NB, CAP) int32, tbl_used (F, NB, CAP)
    bool, and the slot-space maps order, slot_of_sorted (F, K) int64 and
    valid_sorted (F, K) bool.
    """
    band_rows = BAND if band is None else int(band)
    assert band_rows in (8, 16, 32), f"band must be 8/16/32, got {band}"
    nb = ha // band_rows
    f, k = xy.shape[:2]
    r = patch // 2
    cap = CAP * band_rows // 8 if cap is None else int(cap)
    assert cap % 4 == 0 and cap > 0, (
        f"cap must be a positive multiple of 4, got {cap}")
    dev = xy.device

    x0 = torch.clamp(xy[..., 0].to(torch.int32) - r, 0, wp - patch)
    y0 = torch.clamp(xy[..., 1].to(torch.int32) - r, 0, ha - patch)
    bnd = torch.clamp(y0 // band_rows, 0, nb - 1)
    bnd = torch.where(valid, bnd, nb - 1)          # park invalid kpts last

    order = torch.argsort(bnd, dim=-1, stable=True)              # (F, K)
    band_sorted = torch.gather(bnd, 1, order)
    first_idx = torch.searchsorted(
        band_sorted.contiguous(),
        torch.arange(nb, dtype=band_sorted.dtype, device=dev)
        .expand(f, nb).contiguous())                             # (F, NB)
    pos = (torch.arange(k, device=dev)[None]
           - torch.gather(first_idx, 1, band_sorted.long()))
    keep = pos < cap
    slot = torch.clamp(pos, 0, cap - 1)
    flat = torch.where(keep, band_sorted.long() * cap + slot, nb * cap)

    def scatter(vals, dtype):
        out = torch.zeros((f, nb * cap + 1), dtype=dtype, device=dev)
        out.scatter_(1, flat, vals.to(dtype))
        return out[:, :nb * cap].reshape(f, nb, cap)

    tbl_x0 = scatter(torch.gather(x0, 1, order), torch.int32)
    tbl_y0 = scatter(torch.gather(y0, 1, order), torch.int32)
    tbl_used = scatter(keep & torch.gather(valid, 1, order), torch.bool)
    base = (torch.arange(nb, device=dev, dtype=torch.int32)
            * band_rows)[None, :, None]
    rel_y = torch.where(tbl_used, tbl_y0 - base,
                        torch.full_like(tbl_y0, -31))
    return {
        "tbl_x0": tbl_x0.contiguous(),
        "rel_y": rel_y.to(torch.int32).contiguous(),
        "tbl_used": tbl_used,
        "order": order,
        "slot_of_sorted": torch.where(keep, flat, 0),
        "valid_sorted": torch.gather(valid, 1, order) & keep,
        "band": band_rows,
    }
