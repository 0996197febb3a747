"""Banded slot extraction: the ORB extraction routes and their kernels.

Inputs are the atlas, its Gaussian blur and the (NB, CAP) slot tables of
ops/atlas.py `band_tables`, with a leading frame axis. Outputs live in slot
space (S = NB*CAP slots per frame); parked slots (rel_y < 0) give zeros.

  K2  `extract_brief`                  bits (F, S, 256) uint8, m10, m01 (F, S)
      (rpe_tpu/ops/extract_pallas.py `extract_windows_t_brief`, continuous
      steering);
  K12 `extract_brief(binned=True)`     the same with the ORB paper's 30-bin
      steering (`extract_windows_t_brief(binned=True)`);
  K8  `extract_patches`                raw and blurred patches (F, S, 31, 31)
      (`extract_windows`);
  K9  `extract_patches_moments`        blurred patches, m10, m01
      (`extract_windows_moments`);
  K10 `extract_patches_t`              blurred patches transposed, m10, m01
      (`extract_windows_t`).

K2 and K12 follow RPE_BRIEF and RPE_BRIEF_QUANT (read at call time, or
given): a pattern that reaches past the kernel's narrow sample radius
(OpenCV's) takes its wide mode, and rounded samples their own
(`brief_mode`). The reference pads each patch to 32x32 (a TPU lane
layout); here patches are 31x31. `extract_route` picks the route from the reference's kernel
gates. Each wrapper launches its CUDA kernel on CUDA tensors and takes its
plain version on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils.observability import htod
from . import kernels
from .fast import kernel_gate
from .orb import N_BRIEF_BINS, PATCH, PATCH_R, _ic_angle_masks, \
    brief_bin_tables, brief_bin_vectors, brief_kind, brief_pattern, \
    brief_quant, ic_moments, steered_brief, steered_brief_t_binned


def extract_route() -> str:
    """The kernel (launch counter name) that computes what the reference's
    extraction computes on the TPU under the current kernel gates
    (rpe_tpu/ops/atlas.py:267-363, read at call time):

      RPE_EXTRACT_T and RPE_EXTRACT_T_BRIEF on (the default): K2, whose
        function the reference's v3, v4, sparse, quad and v8 bodies all
        compute; RPE_EXTRACT_T_V7 on (and RPE_EXTRACT_T_V8 off): K12;
      RPE_EXTRACT_T on, RPE_EXTRACT_T_BRIEF off: K10;
      RPE_EXTRACT_T off, RPE_PALLAS_EXTRACT and RPE_EXTRACT_MOMENTS on: K9;
      otherwise K8 (with RPE_PALLAS_EXTRACT off too, the reference's XLA
        one-hot path, which computes K8's function).
    """
    if kernel_gate("RPE_EXTRACT_T"):
        if not kernel_gate("RPE_EXTRACT_T_BRIEF"):
            return "extract_patches_t"
        if kernel_gate("RPE_EXTRACT_T_V7") and not kernel_gate(
                "RPE_EXTRACT_T_V8"):
            return "extract_brief_binned"
        return "extract_brief"
    if kernel_gate("RPE_PALLAS_EXTRACT") and kernel_gate(
            "RPE_EXTRACT_MOMENTS"):
        return "extract_patches_moments"
    return "extract_patches"


def _brief_tables_np(kind: str | None = None):
    """K2's and K12's static tables of the BRIEF pattern `brief_kind(kind)`
    in csrc/extract_brief.cu's layouts, so that each warp-wide load reads
    consecutive addresses (a lane samples pairs lane * 8 + k, k < 8):
      pat (256, 4) float32: (x0, y0, x1, y1) of pair lane * 8 + k at row
        k * 32 + lane;
      pairs (30, 2, 32, 4) int32: at [b, h, lane, q], the two row-major
        sample indices iy * 31 + ix of pair lane * 8 + h * 4 + q at bin b
        (`brief_bin_tables`), point 0 in the low and point 1 in the high 16
        bits;
      bin_cs (60,) float32: the bins' cos, then sin."""
    pat = brief_pattern(kind=kind).astype(np.float32)
    ix, iy = brief_bin_tables(kind=kind)
    idx = (iy * PATCH + ix).astype(np.int32)                  # (30, 512)
    pairs = (idx[:, :256] | (idx[:, 256:] << 16)).reshape(
        N_BRIEF_BINS, 32, 2, 4)
    return (pat.reshape(32, 8, 4).transpose(1, 0, 2).reshape(256, 4),
            pairs.transpose(0, 2, 1, 3), np.concatenate(brief_bin_vectors()))


def _brief_tables(dev: torch.device, kind: str | None = None):
    """`_brief_tables_np(kind)` on `dev`, copied there once per device and
    kind. `dev` is a tensor's device, so a card comes with its index."""
    return _brief_tables_on(dev, brief_kind(kind))


@functools.lru_cache(maxsize=None)
def _brief_tables_on(dev: torch.device, kind: str):
    return tuple(htod(np.ascontiguousarray(a), dev)
                 for a in _brief_tables_np(kind))


def pattern_reach2(kind: str | None = None) -> int:
    """Squared radius of the BRIEF pattern's outermost point."""
    return _reach2(brief_kind(kind))


@functools.lru_cache(maxsize=None)
def _reach2(kind: str) -> int:
    return int((brief_pattern(kind=kind).astype(np.int64) ** 2).sum(-1).max())


def ic_umax():
    """The IC mask's half-widths umax[|v|], v = 0..15 (16,) int: row v of
    `_ic_angle_masks()`'s mask covers |u| <= umax[|v|]."""
    mask = _ic_angle_masks()[0]
    return (mask[PATCH_R:].sum(axis=1).astype(np.int64) - 1) // 2


def _check_umax(source, umax):
    """Raise unless the IC mask extents a library hard-codes are
    `ic_umax()`."""
    if list(umax) != ic_umax().tolist():
        raise RuntimeError(f"{source} umax {list(umax)} disagrees with "
                           f"ops/orb.py _ic_angle_masks() "
                           f"{ic_umax().tolist()}")


@functools.lru_cache(maxsize=None)
def _brief_launcher(lib):
    """K2's and K12's launcher with its argument types set, once per loaded
    library, after holding what the kernel hard-codes to what the port
    computes: its IC mask extents to `ic_umax()`; its narrow sample radius
    (the blurred pixels it copies, its unclamped K2 samples) to the default
    pattern's reach, so the default path takes the narrow mode; its wide
    radius to the patch rim, where the plain version clips samples."""
    layout = _brief_layout(lib)
    _check_umax("extract_brief.cu", layout[:PATCH_R + 1])
    narrow_r, wide_r = layout[PATCH_R + 1:]
    reach = pattern_reach2("gauss")
    if reach > narrow_r ** 2:
        raise RuntimeError(f"extract_brief.cu samples within radius "
                           f"{narrow_r}; the default BRIEF pattern reaches "
                           f"radius {reach ** 0.5:.2f}")
    if wide_r != PATCH_R:
        raise RuntimeError(f"extract_brief.cu's wide mode clamps samples to "
                           f"radius {wide_r}; the plain version clips them to "
                           f"the patch rim, radius {PATCH_R}")
    return _typed(lib.extract_brief_launch, 10)


@functools.lru_cache(maxsize=None)
def _brief_layout(lib):
    """What `lib` (a build of csrc/extract_brief.cu) hard-codes: the IC
    mask's extents umax[0..15], then its narrow and wide sample radii."""
    buf = (ctypes.c_int * (PATCH_R + 3))()
    lib.extract_brief_layout(buf)
    return tuple(buf)


# csrc/extract_brief.cu's mode bits
MODE_BINNED, MODE_WIDE, MODE_QUANT = 1, 2, 4


def brief_mode(lib, binned: bool, quant: bool, kind: str) -> int:
    """The launcher's mode for K2 (K12 with `binned`): the wide sample
    radius when the pattern `kind` reaches past the narrow one, rounded
    samples with `quant`."""
    wide = pattern_reach2(kind) > _brief_layout(lib)[PATCH_R + 1] ** 2
    return ((MODE_BINNED if binned else 0) | (MODE_WIDE if wide else 0)
            | (MODE_QUANT if quant else 0))


@functools.lru_cache(maxsize=None)
def _patch_launcher(lib):
    """K8-K10's launcher with its argument types set, once per loaded
    library, after holding K9's and K10's IC mask extents to
    `ic_umax()`."""
    buf = (ctypes.c_int * (PATCH_R + 1))()
    lib.extract_patches_layout(buf)
    _check_umax("extract_patches.cu", buf[:])
    return _typed(lib.extract_patches_launch, 8)


def _typed(fn, n_ptrs):
    """Both sources' launchers take (mode, n_ptrs pointers, F, HA, WP, NB,
    CAP, band, stream) and return a cudaError_t."""
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * n_ptrs + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_slot_patches(img, tbl_x0, rel_y, band: int):
    """(F, HA, WP) image -> (F, NB*CAP, PATCH, PATCH) patches of every slot;
    parked slots (rel_y < 0) give zero patches."""
    f, nb, cap = tbl_x0.shape
    ha, wp = img.shape[-2:]
    dev = img.device
    y0 = (torch.arange(nb, device=dev, dtype=torch.int64)[None, :, None]
          * band + rel_y.long())                                  # (F,NB,CAP)
    live = (rel_y >= 0).reshape(f, nb * cap)
    y0 = torch.where(rel_y >= 0, y0, 0).reshape(f, nb * cap)
    x0 = tbl_x0.long().reshape(f, nb * cap)
    pj = torch.arange(PATCH, device=dev)
    rows = (y0[..., None] + pj).clamp(0, ha - 1)                  # (F, S, P)
    cols = (x0[..., None] + pj).clamp(0, wp - 1)
    flat = rows[..., :, None] * wp + cols[..., None, :]           # (F,S,P,P)
    out = torch.gather(img.reshape(f, 1, ha * wp).expand(f, nb * cap, -1),
                       2, flat.reshape(f, nb * cap, PATCH * PATCH))
    out = out.reshape(f, nb * cap, PATCH, PATCH)
    return torch.where(live[..., None, None], out,
                       torch.zeros((), dtype=out.dtype, device=dev))


# ---- plain versions ------------------------------------------------------

def extract_patches_plain(atlas, blurred, tbl_x0, rel_y, band: int):
    """Plain version of K8: (raw, blur) patches (F, S, PATCH, PATCH)."""
    return (gather_slot_patches(atlas, tbl_x0, rel_y, band),
            gather_slot_patches(blurred, tbl_x0, rel_y, band))


def extract_patches_moments_plain(atlas, blurred, tbl_x0, rel_y, band: int):
    """Plain version of K9: blur patches and the raw patches' IC moments."""
    raw, blur = extract_patches_plain(atlas, blurred, tbl_x0, rel_y, band)
    m10, m01 = ic_moments(raw)
    return blur, m10, m01


def extract_patches_t_plain(atlas, blurred, tbl_x0, rel_y, band: int):
    """Plain version of K10: K9's outputs with the blur patches transposed,
    blur_t[..., u, v] = blurred[y0 + v, x0 + u]."""
    blur, m10, m01 = extract_patches_moments_plain(atlas, blurred, tbl_x0,
                                                   rel_y, band)
    return blur.transpose(-1, -2).contiguous(), m10, m01


def extract_brief_plain(atlas, blurred, tbl_x0, rel_y, band: int,
                        binned: bool = False, quant: bool | None = None,
                        kind: str | None = None):
    """Plain version of K2 (and with `binned`, K12): IC moments of the raw
    patches, then BRIEF of the blurred patches at the angle atan2(m01, m10)
    through cos/sin, as the reference computes it off the TPU
    (rpe_tpu/ops/atlas.py:365-449, ops/orb.py:436-446); K12 samples the
    transposed patches at the moments' steering bin
    (`orb.steered_brief_t_binned`). The pattern is `brief_kind(kind)`, and
    samples round half-to-even first when `brief_quant(quant)`."""
    f, s = tbl_x0.shape[0], tbl_x0.shape[1] * tbl_x0.shape[2]
    if binned:
        blur_t, m10, m01 = extract_patches_t_plain(atlas, blurred, tbl_x0,
                                                   rel_y, band)
        bits = steered_brief_t_binned(blur_t.reshape(f * s, PATCH, PATCH),
                                      m10.reshape(-1), m01.reshape(-1),
                                      quant, kind)
    else:
        blur, m10, m01 = extract_patches_moments_plain(atlas, blurred, tbl_x0,
                                                       rel_y, band)
        bits = steered_brief(blur.reshape(f * s, PATCH, PATCH),
                             torch.atan2(m01, m10).reshape(-1), quant, kind)
    return bits.reshape(f, s, 256), m10, m01


# ---- kernel wrappers -----------------------------------------------------

def _check(name, atlas, blurred, tbl_x0, rel_y):
    """The kernels' preconditions; returns (F, HA, WP, NB, CAP)."""
    if (atlas.dim() != 3 or atlas.shape != blurred.shape
            or atlas.dtype != torch.float32 or blurred.dtype != torch.float32):
        raise ValueError(f"{name}: atlas/blurred must be matching "
                         "(F, HA, WP) float32")
    if (tbl_x0.shape != rel_y.shape or tbl_x0.dim() != 3
            or tbl_x0.shape[0] != atlas.shape[0]
            or tbl_x0.dtype != torch.int32 or rel_y.dtype != torch.int32):
        raise ValueError(f"{name}: tables must be (F, NB, CAP) int32")
    kernels.require_cuda(name, atlas=atlas, blurred=blurred, tbl_x0=tbl_x0,
                         rel_y=rel_y)
    return (*atlas.shape, *tbl_x0.shape[1:])


def _ptrs(*tensors):
    return [None if t is None else kernels.ptr(t) for t in tensors]


def extract_brief(atlas, blurred, tbl_x0, rel_y, band: int,
                  binned: bool = False, quant: bool | None = None,
                  kind: str | None = None):
    """K2 (K12 with `binned`): (bits (F, S, 256) uint8, m10, m01 (F, S))
    with the BRIEF pattern `brief_kind(kind)`, samples rounded when
    `brief_quant(quant)` (both read from the environment when None). CUDA
    tensors launch csrc/extract_brief.cu in the mode those ask for
    (`brief_mode`); CPU tensors take `extract_brief_plain`."""
    kind, quant = brief_kind(kind), brief_quant(quant)
    if atlas.device.type == "cpu":
        return extract_brief_plain(atlas, blurred, tbl_x0, rel_y, band,
                                   binned, quant, kind)
    return _launch_brief(kernels.lib("extract_brief"), atlas, blurred, tbl_x0,
                         rel_y, band, binned, quant, kind)


def _launch_brief(lib, atlas, blurred, tbl_x0, rel_y, band, binned,
                  quant=False, kind="gauss"):
    """K2 (K12 with `binned`) launched from `lib`, a build of
    csrc/extract_brief.cu, with pattern `kind` and `quant`."""
    name = "extract_brief_binned" if binned else "extract_brief"
    f, ha, wp, nb, cap = _check(name, atlas, blurred, tbl_x0, rel_y)
    dev = atlas.device
    pat, pairs, bin_cs = _brief_tables(dev, kind)
    bits = torch.empty((f, nb * cap, 256), dtype=torch.uint8, device=dev)
    m10 = torch.empty((f, nb * cap), dtype=torch.float32, device=dev)
    m01 = torch.empty_like(m10)
    kernels.launch(name, _brief_launcher(lib), atlas,
                   brief_mode(lib, binned, quant, kind),
                   *_ptrs(atlas, blurred, tbl_x0, rel_y, pat, pairs, bin_cs,
                          bits, m10, m01),
                   f, ha, wp, nb, cap, int(band))
    return bits, m10, m01


# mode of csrc/extract_patches.cu per patch kernel
_PATCH_MODES = {"extract_patches": 0, "extract_patches_moments": 1,
                "extract_patches_t": 2}


def _launch_patches(lib, name, atlas, blurred, tbl_x0, rel_y, band):
    """K8, K9 or K10 (`name`) launched from `lib`, a build of
    csrc/extract_patches.cu."""
    f, ha, wp, nb, cap = _check(name, atlas, blurred, tbl_x0, rel_y)
    dev = atlas.device
    blur = torch.empty((f, nb * cap, PATCH, PATCH), dtype=torch.float32,
                       device=dev)
    if name == "extract_patches":
        raw, m10, m01 = torch.empty_like(blur), None, None
    else:
        raw = None
        m10 = torch.empty((f, nb * cap), dtype=torch.float32, device=dev)
        m01 = torch.empty_like(m10)
    kernels.launch(name, _patch_launcher(lib), atlas, _PATCH_MODES[name],
                   *_ptrs(atlas, blurred, tbl_x0, rel_y, raw, blur, m10, m01),
                   f, ha, wp, nb, cap, int(band))
    return (raw, blur) if m10 is None else (blur, m10, m01)


def extract_patches(atlas, blurred, tbl_x0, rel_y, band: int):
    """K8: (raw, blur) patches (F, S, 31, 31) float32; CUDA tensors launch
    csrc/extract_patches.cu, CPU tensors take `extract_patches_plain`."""
    if atlas.device.type == "cpu":
        return extract_patches_plain(atlas, blurred, tbl_x0, rel_y, band)
    return _launch_patches(kernels.lib("extract_patches"), "extract_patches",
                           atlas, blurred, tbl_x0, rel_y, band)


def extract_patches_moments(atlas, blurred, tbl_x0, rel_y, band: int):
    """K9: (blur (F, S, 31, 31), m10, m01 (F, S)); CUDA tensors launch
    csrc/extract_patches.cu, CPU tensors take the plain version."""
    if atlas.device.type == "cpu":
        return extract_patches_moments_plain(atlas, blurred, tbl_x0, rel_y,
                                             band)
    return _launch_patches(kernels.lib("extract_patches"),
                           "extract_patches_moments", atlas, blurred, tbl_x0,
                           rel_y, band)


def extract_patches_t(atlas, blurred, tbl_x0, rel_y, band: int):
    """K10: (blur_t (F, S, 31, 31) transposed, m10, m01 (F, S)); CUDA
    tensors launch csrc/extract_patches.cu, CPU tensors take the plain
    version."""
    if atlas.device.type == "cpu":
        return extract_patches_t_plain(atlas, blurred, tbl_x0, rel_y, band)
    return _launch_patches(kernels.lib("extract_patches"),
                           "extract_patches_t", atlas, blurred, tbl_x0, rel_y,
                           band)
