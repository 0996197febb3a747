"""Scale pyramid, reflect-101 Gaussian blur and box filter (port of
rpe_tpu/ops/pyramid.py).

Level sizes follow OpenCV's rounding (size_l = round(size_0 / 1.1^l)) and are
static Python ints. The default ORB path builds the pyramid inside the fused
atlas (ops/atlas.py `build_atlas_fused`); `build_pyramid` gives the levels
one by one, for the unfused atlas and the per-level ORB path.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.observability import htod


def level_shapes(h: int, w: int, nlevels: int = 12, scale_factor: float = 1.1):
    """Static per-level (h, w) following OpenCV's cvRound(size / scale^l)."""
    shapes = []
    for l in range(nlevels):
        s = scale_factor ** l
        shapes.append((int(round(h / s)), int(round(w / s))))
    return shapes


@functools.lru_cache(maxsize=None)
def resize_weights(n_in: int, n_out: int):
    """(n_in, n_out) float32 numpy weights of jax.image.resize(...,
    "linear") along one axis, computed as it computes them: in float32,
    half-pixel centres, the triangle kernel widened by the zoom factor when
    shrinking (anti-aliased), columns normalised to sum 1. The sample
    position (j + 0.5) / scale - 0.5 rounds once, as the compiled reference
    evaluates it (a fused multiply-add); the weights then agree with the
    reference's to ~1.5e-6 (tests/test_torch_switches.py)."""
    f = np.float32
    inv = f(1.0 / (n_out / n_in))
    ks = max(inv, f(1.0))
    a = np.arange(n_out, dtype=f) + f(0.5)
    pos = (a.astype(np.longdouble) * np.longdouble(inv)
           - np.longdouble(0.5)).astype(f)
    x = np.abs(pos[None, :] - np.arange(n_in, dtype=f)[:, None]) / ks
    w = np.maximum(f(0), f(1) - x).astype(f)
    tot = w.sum(axis=0, keepdims=True, dtype=f)
    w = np.where(np.abs(tot) > f(1000 * np.finfo(np.float32).eps),
                 w / np.where(tot != 0, tot, f(1)), f(0))
    inside = (pos >= -0.5) & (pos <= n_in - 0.5)
    return np.where(inside[None], w, f(0)).astype(f)


def build_pyramid(img, nlevels: int = 12, scale_factor: float = 1.1):
    """img (F, H, W) float32 -> list of `nlevels` tensors (F, h_l, w_l),
    level 0 the input: each level jax.image.resize(..., "linear") of the
    input as two float32 products with `resize_weights`, rows then columns.
    Callers keep TF32 off (utils/device.py `full_precision`)."""
    f, h, w = img.shape
    dev = img.device
    levels = [img]
    for lh, lw in level_shapes(h, w, nlevels, scale_factor)[1:]:
        rows = htod(resize_weights(h, lh).T.copy(), dev)
        cols = htod(resize_weights(w, lw), dev)
        levels.append(torch.matmul(torch.matmul(rows, img), cols))
    return levels


def gaussian_blur(img, ksize: int = 7, sigma: float = 2.0):
    """Separable Gaussian blur over the last two axes with reflect-101
    padding (OpenCV BORDER_REFLECT_101), the 7x7 sigma-2 blur OpenCV ORB
    applies before sampling: a vertical pass, then a horizontal one, each
    adding its taps from the top (left) of the window. Not the wrapped
    blur of K1 and the atlas (ops/atlas.py `gaussian_blur_rolled`)."""
    from .atlas import gaussian_weights

    r = ksize // 2
    k = gaussian_weights(ksize, sigma)
    shape = img.shape
    h, w = shape[-2:]
    pad = torch.nn.functional.pad
    x = pad(img.reshape(-1, h, w), (0, 0, r, r), mode="reflect")
    v = torch.zeros((x.shape[0], h, w), dtype=img.dtype, device=img.device)
    for i in range(ksize):
        v = v + k[i] * x[:, i:i + h]
    x = pad(v, (r, r), mode="reflect")
    out = torch.zeros_like(v)
    for i in range(ksize):
        out = out + k[i] * x[..., i:i + w]
    return out.reshape(shape)


def box_filter(img, ksize: int):
    """Unnormalized ksize x ksize box sum over the last two axes, zero
    padded: a vertical pass, then a horizontal one, each adding its taps in
    order from the top (left) edge of the window."""
    r = ksize // 2
    h, w = img.shape[-2:]
    x = torch.nn.functional.pad(img, (0, 0, r, r))
    v = torch.zeros_like(img)
    for i in range(ksize):
        v = v + x[..., i:i + h, :]
    x = torch.nn.functional.pad(v, (r, r))
    out = torch.zeros_like(img)
    for i in range(ksize):
        out = out + x[..., :, i:i + w]
    return out
