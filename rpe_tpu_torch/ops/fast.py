"""FAST-9/16 corners, 3x3 nonmax and Harris response as dense maps, and the
fused rank-map kernel K1 (port of rpe_tpu/ops/fast.py and the function of
rpe_tpu/ops/fast_pallas.py `fast_harris_rank_map`).

Every map function works over the last two axes with any leading batch.
`detect_level` is the per-level detector of the reference's RPE_NO_ATLAS
path (K1 on each level image, then the border mask and the top-k). Also
the reference's kernel-gate environment switches (`kernel_gate`), which
choose the ORB extraction route (ops/extract.py `extract_route`).
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from . import kernels
from .atlas import gaussian_blur_rolled, gaussian_weights
from .pyramid import box_filter

# Bresenham circle of radius 3 (OpenCV FAST-16 order, clockwise from 12
# o'clock): (dx, dy) with y down.
_CIRCLE = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], dtype=np.int32)


# The reference's hardware-validated kernel gates (rpe_tpu/ops/fast.py
# `_VALIDATED_KERNEL_GATES`): on unless set to an off value.
_VALIDATED_KERNEL_GATES = frozenset({
    "RPE_PALLAS_5PT",
    "RPE_PALLAS_EXTRACT",
    "RPE_PALLAS_MATCH",
    "RPE_EXTRACT_T",
    "RPE_EXTRACT_T_BRIEF",
    "RPE_EXTRACT_MOMENTS",
    "RPE_EXTRACT_T_QUAD",
})

_GATE_OFF = ("", "0", "off", "false", "no")


def kernel_gate(name: str) -> bool:
    """True iff the named gate is on, read from the environment at call
    time: unset means the validated default (on for the names in
    `_VALIDATED_KERNEL_GATES`, off otherwise); "", "0", "off", "false" and
    "no" (any case, outer spaces ignored) mean off; anything else on."""
    v = os.environ.get(name)
    if v is None:
        return name in _VALIDATED_KERNEL_GATES
    return v.strip().lower() not in _GATE_OFF


def _neighbor(img, dx: int, dy: int):
    """img[y + dy, x + dx] with wrap-around on both axes."""
    return torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1))


def _circular_run_ge9(b):
    """b: (16, ...) bool -> any circular run of >= 9 set entries."""
    def rot(x, s):
        return torch.roll(x, -s, dims=0)

    s2 = b & rot(b, 1)
    s4 = s2 & rot(s2, 2)
    s8 = s4 & rot(s4, 4)
    s9 = s8 & rot(b, 8)
    return torch.any(s9, dim=0)


def fast_score_map(img, threshold: float = 15.0):
    """Dense FAST corner score: 0 where not a corner, else the arc-margin
    score (sum of |diff| - t over the stronger of the bright/dark sets). The
    16 margin terms are added in _CIRCLE order."""
    diffs = [_neighbor(img, int(dx), int(dy)) - img for dx, dy in _CIRCLE]
    bright = torch.stack([d > threshold for d in diffs])
    dark = torch.stack([d < -threshold for d in diffs])
    is_corner = _circular_run_ge9(bright) | _circular_run_ge9(dark)
    score_b = torch.zeros_like(img)
    score_d = torch.zeros_like(img)
    zero = torch.zeros((), dtype=img.dtype, device=img.device)
    for d in diffs:
        score_b = score_b + torch.where(d > threshold, d - threshold, zero)
        score_d = score_d + torch.where(d < -threshold, -d - threshold, zero)
    score = torch.maximum(score_b, score_d)
    return torch.where(is_corner, score, zero)


def nonmax_suppress_3x3(score):
    """Keep only 3x3-local maxima of a nonnegative score map."""
    shape = score.shape
    s4 = score.reshape(-1, 1, *shape[-2:])
    m = torch.nn.functional.max_pool2d(s4, 3, stride=1, padding=1)
    m = m.reshape(shape)
    return torch.where((score >= m) & (score > 0.0), score,
                       torch.zeros((), dtype=score.dtype, device=score.device))


def harris_response_map(img, block_size: int = 7, k: float = 0.04):
    """Dense Harris response: central-difference gradients, block_size^2
    box sums of the gradient products, R = det(M) - k * trace(M)^2."""
    dx = _neighbor(img, 1, 0) - _neighbor(img, -1, 0)
    dy = _neighbor(img, 0, 1) - _neighbor(img, 0, -1)
    a = box_filter(dx * dx, block_size)
    b = box_filter(dy * dy, block_size)
    c = box_filter(dx * dy, block_size)
    return (a * b - c * c) - k * ((a + b) * (a + b))


def fast_harris_rank_map_plain(img, threshold: float = 15.0,
                               k_harris: float = 0.04):
    """Plain version of K1: (rank, blurred) for (F, H, W) float32 images."""
    score = nonmax_suppress_3x3(fast_score_map(img, threshold))
    rank = torch.where(score > 0.0, harris_response_map(img, k=k_harris),
                       torch.full((), -torch.inf, dtype=img.dtype,
                                  device=img.device))
    return rank, gaussian_blur_rolled(img)


# the kernel's Gaussian taps, passed by reference to every launch
_GAUSS7 = (ctypes.c_float * 7)(*gaussian_weights())


def fast_harris_rank_map(img, threshold: float = 15.0,
                         k_harris: float = 0.04):
    """K1: rank map (Harris response where a FAST-9 corner survives 3x3
    nonmax of its score, -inf elsewhere) and the 7x7 sigma-2 Gaussian blur,
    from one pass over each (H, W) image of img (F, H, W) float32.

    Replaces rpe_tpu/ops/fast_pallas.py `fast_harris_rank_map`. A CUDA
    tensor launches csrc/fast_harris.cu; a CPU tensor takes the plain
    version. Both wrap at the image edges; the kernel's Harris box sums
    and 3x3 nonmax wrap where the plain version pads (zeros, -inf), which
    differs only within 4 px of an edge (the detector masks a 19 px
    border).
    """
    if img.device.type == "cpu":
        return fast_harris_rank_map_plain(img, threshold, k_harris)
    if img.dim() != 3 or img.dtype != torch.float32:
        raise ValueError(f"fast_harris_rank_map: want (F, H, W) float32, "
                         f"got {tuple(img.shape)} {img.dtype}")
    kernels.require_cuda("fast_harris_rank_map", img=img)
    f, h, w = img.shape
    if h < 9 or w < 9:
        raise ValueError("fast_harris_rank_map: image smaller than 9x9")
    if not threshold >= 0.0:
        # the kernel takes the bright and dark masks as exclusive
        raise ValueError("fast_harris_rank_map: threshold must be >= 0")
    rank = torch.empty_like(img)
    blur = torch.empty_like(img)
    kernels.launch("fast_harris", _launcher(kernels.lib("fast_harris")), img,
                   kernels.ptr(img), kernels.ptr(rank), kernels.ptr(blur), f,
                   h, w, float(threshold), float(k_harris), _GAUSS7)
    return rank, blur


@functools.lru_cache(maxsize=None)
def _launcher(lib):
    """The library's launcher with its argument types set (once per loaded
    library)."""
    fn = lib.fast_harris_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def border_mask(h: int, w: int, margin: int, device=None):
    """(h, w) bool: True where a keypoint is allowed (static margins)."""
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= margin) & (ys < h - margin) & (xs >= margin) & (
        xs < w - margin)


def detect_level(img, threshold: float, margin: int, quota: int):
    """FAST + nonmax + Harris top-`quota` selection on one pyramid level of
    each frame, img (F, h, w) float32 (rpe_tpu/ops/fast.py `detect_level`):
    K1's rank map (its plain version on a CPU tensor; its blur unused), -inf
    within `margin` of the border, then `top_k_stable` over the flattened
    map. Returns xy (F, quota, 2) float32 (x, y) level pixel coords,
    harris (F, quota) float32 and valid (F, quota) bool. The margin covers
    the 4 px edge band where K1 wraps and its plain version pads, so both
    give the same keypoints."""
    from .orb import top_k_stable

    f, h, w = img.shape
    rank, _ = fast_harris_rank_map(img, float(threshold))
    rank = torch.where(border_mask(h, w, margin, img.device), rank,
                       torch.full((), -torch.inf, dtype=rank.dtype,
                                  device=img.device))
    vals, flat = top_k_stable(rank.reshape(f, h * w), quota)
    xy = torch.stack([(flat % w).to(torch.float32),
                      (flat // w).to(torch.float32)], dim=-1)
    return xy, vals, vals > -torch.inf
