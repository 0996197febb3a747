"""ORB detection + description (port of rpe_tpu/ops/orb.py).

Per frame, on the default atlas path: the fused pyramid atlas, the K1 rank
map and blur (ops/fast.py), a per-level Harris top-k to OpenCV's geometric
quotas, the banded slot tables (ops/atlas.py), and the extraction route that
the reference's kernel gates select (ops/extract.py `extract_route`: K2 by
default) for the IC angle and the steered 256-bit BRIEF descriptor. With
RPE_NO_FUSED_ATLAS the atlas is built from the per-level pyramid instead;
with RPE_NO_ATLAS (or use_atlas=False) each level is detected by its own K1
launch and described by the plain gathers (`orb_detect_and_describe`).
RPE_BRIEF=cv2 takes OpenCV's learned pattern, and RPE_BRIEF_QUANT rounds the
sampled values before the compare (`brief_quant`). Every switch is read at
call time. Frames are batched on a leading axis; outputs are static-size
slot arrays with a validity mask.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..utils.observability import htod

PATCH_R = 15          # orientation circle radius (OpenCV HALF_PATCH_SIZE)
PATCH = 2 * PATCH_R + 1
PATTERN_R = 13        # max BRIEF pattern point radius (rotation-safe < 15)
EDGE_MARGIN = 19      # keypoint exclusion border (OpenCV internal EDGE_THRESHOLD)


def level_quotas(nfeatures: int, nlevels: int, scale_factor: float):
    """OpenCV ORB's geometric per-level feature quota (static ints)."""
    factor = 1.0 / scale_factor
    ndesired0 = nfeatures * (1.0 - factor) / (1.0 - factor ** nlevels)
    quotas, total = [], 0
    for l in range(nlevels - 1):
        q = int(round(ndesired0 * factor ** l))
        quotas.append(q)
        total += q
    quotas.append(max(nfeatures - total, 0))
    return quotas


def brief_kind(kind: str | None = None) -> str:
    """The BRIEF pattern's kind: `kind`, else RPE_BRIEF, else "gauss";
    every kind but "cv2" is the Gaussian pattern, as in the reference."""
    if kind is None:
        kind = os.environ.get("RPE_BRIEF", "gauss")
    return "cv2" if kind == "cv2" else "gauss"


def brief_quant(quant: bool | None = None) -> bool:
    """Whether sampled values round half-to-even before the compare:
    `quant`, else RPE_BRIEF_QUANT as the reference parses it
    (rpe_tpu/ops/orb.py:187-193) -- unset means on iff RPE_BRIEF is "cv2",
    "" and "0" mean off, anything else on."""
    if quant is not None:
        return bool(quant)
    q = os.environ.get("RPE_BRIEF_QUANT")
    if q is None:
        q = "1" if os.environ.get("RPE_BRIEF") == "cv2" else ""
    return bool(q) and q != "0"


def brief_pattern(n_pairs: int = 256, seed: int = 12345,
                  kind: str | None = None):
    """BRIEF pattern: (n_pairs, 2, 2) int32 (x, y), by `brief_kind`:
      "gauss": points ~ N(0, (31/5)^2) rounded, kept by rejection within
        radius PATTERN_R so any rotation stays inside the 31x31 patch;
      "cv2": OpenCV's learned layout (ops/brief_cv2_pattern.py); 47 of its
        points lie past radius 15, and a rotation that carries one past the
        patch samples its rim."""
    return _brief_pattern_cached(n_pairs, seed, brief_kind(kind))


@functools.lru_cache(maxsize=None)
def _brief_pattern_cached(n_pairs: int, seed: int, kind: str):
    if kind == "cv2":
        from .brief_cv2_pattern import CV2_BRIEF_PATTERN

        pts = np.array(CV2_BRIEF_PATTERN, dtype=np.int32)
        assert pts.shape == (n_pairs, 4)
        return pts.reshape(n_pairs, 2, 2)
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < n_pairs * 2:
        cand = rng.normal(0.0, 31.0 / 5.0, size=(n_pairs * 4, 2))
        cand = np.round(cand).astype(np.int32)
        ok = (cand[:, 0] ** 2 + cand[:, 1] ** 2) <= PATTERN_R ** 2
        pts.extend([tuple(p) for p in cand[ok]])
    return np.array(pts[: n_pairs * 2], dtype=np.int32).reshape(n_pairs, 2, 2)


@functools.lru_cache(maxsize=None)
def _ic_angle_masks():
    """Circular-region mask and (u, v) grids for IC_Angle (numpy f32).

    OpenCV's umax table: round(sqrt(225 - v^2)) for |v| <= floor(15/sqrt(2))
    + 1, then symmetrized for larger |v| so the region is mirror-equal under
    u <-> v."""
    hp = PATCH_R
    umax = [0] * (hp + 2)
    vmax = int(np.floor(hp * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(hp * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(np.rint(np.sqrt(hp * hp - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    u_max = np.array([umax[abs(v)] for v in range(-hp, hp + 1)])
    vs, us = np.mgrid[-PATCH_R:PATCH_R + 1, -PATCH_R:PATCH_R + 1]
    mask = np.abs(us) <= u_max[:, None]
    return (mask.astype(np.float32), us.astype(np.float32),
            vs.astype(np.float32))


def ic_moments(patches):
    """Intensity-centroid moments (m10, m01) of (K, PATCH, PATCH) patches."""
    mask_np, us_np, vs_np = _ic_angle_masks()
    dev = patches.device
    mask, us, vs = (htod(a, dev) for a in (mask_np, us_np, vs_np))
    w = patches * mask
    return (w * us).sum(dim=(-2, -1)), (w * vs).sum(dim=(-2, -1))


def ic_angles(patches):
    """Intensity-centroid orientation per patch: atan2(m01, m10), radians."""
    m10, m01 = ic_moments(patches)
    return torch.atan2(m01, m10)


def gather_patches(img, xy):
    """img (F, H, W), xy (F, K, 2) integer-valued (x, y) patch centres ->
    (F, K, PATCH, PATCH). Corners clamp so the patch lies in the image, as
    the reference's dynamic_slice does (keypoints sit >= EDGE_MARGIN >
    PATCH_R from the border, so the clamp acts on none of them)."""
    f, h, w = img.shape
    k = xy.shape[1]
    x0 = torch.clamp(xy[..., 0].to(torch.int64) - PATCH_R, 0, w - PATCH)
    y0 = torch.clamp(xy[..., 1].to(torch.int64) - PATCH_R, 0, h - PATCH)
    pj = torch.arange(PATCH, device=img.device)
    flat = ((y0[..., None, None] + pj[:, None]) * w
            + x0[..., None, None] + pj)                       # (F, K, P, P)
    out = torch.gather(img.reshape(f, 1, h * w).expand(f, k, -1), 2,
                       flat.reshape(f, k, PATCH * PATCH))
    return out.reshape(f, k, PATCH, PATCH)


def _sample(patches, flat, quant: bool):
    """patches (K, PATCH, PATCH), flat (K, N) indices into each -> (K, N),
    rounded half-to-even if `quant`."""
    k = patches.shape[0]
    vals = torch.gather(patches.reshape(k, PATCH * PATCH), 1, flat)
    return torch.round(vals) if quant else vals


def steered_sample_index(angles, transposed: bool = False,
                         kind: str | None = None):
    """(K,) angles -> (K, 512) patch indices iy * PATCH + ix (ix * PATCH +
    iy if `transposed`) of the BRIEF pattern's points rotated by each angle,
    rounded half-to-even and clipped to the patch; point j of pair k at
    column 2k + j."""
    pat = htod(brief_pattern(kind=kind).astype(np.float32), angles.device)
    ca, sa = torch.cos(angles), torch.sin(angles)
    px, py = pat[..., 0], pat[..., 1]                         # (256, 2)
    rx = px[None] * ca[:, None, None] - py[None] * sa[:, None, None]
    ry = px[None] * sa[:, None, None] + py[None] * ca[:, None, None]
    ix = torch.clamp(torch.round(rx).to(torch.int64) + PATCH_R, 0, PATCH - 1)
    iy = torch.clamp(torch.round(ry).to(torch.int64) + PATCH_R, 0, PATCH - 1)
    flat = ix * PATCH + iy if transposed else iy * PATCH + ix
    return flat.reshape(angles.shape[0], 512)


def _steered_brief(patches, angles, transposed: bool, quant, kind):
    k = patches.shape[0]
    vals = _sample(patches, steered_sample_index(angles, transposed, kind),
                   brief_quant(quant)).reshape(k, 256, 2)
    return (vals[..., 0] < vals[..., 1]).to(torch.uint8)


def steered_brief(patches_blur, angles, quant: bool | None = None,
                  kind: str | None = None):
    """Rotated-pattern BRIEF bits: (K, PATCH, PATCH) blurred patches and
    (K,) angles -> (K, 256) uint8. Each point of the pattern (`brief_kind`)
    is rotated by the angle, rounded half-to-even, clipped to the patch, and
    sampled; the samples round half-to-even first when `brief_quant`."""
    return _steered_brief(patches_blur, angles, False, quant, kind)


def steered_brief_t(patches_blur_t, angles, quant: bool | None = None,
                    kind: str | None = None):
    """steered_brief of TRANSPOSED patches, patch_t[u, v] = patch[v, u] (as
    K10 gives them): the same samples, so the same bits."""
    return _steered_brief(patches_blur_t, angles, True, quant, kind)


N_BRIEF_BINS = 30  # ORB paper section 4.3: steering discretized to 2*pi/30


def brief_bin_tables(n_bins: int = N_BRIEF_BINS, kind: str | None = None):
    """Binned-steering sample tables (numpy) of the pattern `brief_kind`:
    ix_tab, iy_tab (n_bins, 512) int32 patch coordinates in [0, 30] of the
    pattern rotated to each bin centre 2*pi*b/n_bins, column n = j*256 + k
    for point j of pair k. The rotation, round and clip chain is
    steered_brief's, in float32. (The reference also returns the same
    coordinates one-hot, a TPU layout.)"""
    return _brief_bin_tables(n_bins, brief_kind(kind))


@functools.lru_cache(maxsize=None)
def _brief_bin_tables(n_bins: int, kind: str):
    pat = brief_pattern(kind=kind).astype(np.float32)        # (256, 2, 2)
    th = (2.0 * np.pi / n_bins) * np.arange(n_bins)
    ca = np.cos(th).astype(np.float32)[:, None]              # (B, 1)
    sa = np.sin(th).astype(np.float32)[:, None]
    px = pat[:, :, 0].T.reshape(-1).astype(np.float32)[None]  # (1, 512)
    py = pat[:, :, 1].T.reshape(-1).astype(np.float32)[None]
    rx = px * ca - py * sa                                   # (B, 512) f32
    ry = px * sa + py * ca
    ix = np.clip(np.rint(rx).astype(np.int32) + PATCH_R, 0, 2 * PATCH_R)
    iy = np.clip(np.rint(ry).astype(np.int32) + PATCH_R, 0, 2 * PATCH_R)
    return ix, iy


@functools.lru_cache(maxsize=None)
def brief_bin_vectors(n_bins: int = N_BRIEF_BINS):
    """(cos, sin) of the bin centres, float32 numpy (n_bins,)."""
    th = (2.0 * np.pi / n_bins) * np.arange(n_bins)
    return np.cos(th).astype(np.float32), np.sin(th).astype(np.float32)


def angle_bins(m10, m01, n_bins: int = N_BRIEF_BINS):
    """Nearest steering bin of raw IC moments (K,) -> (K,) int32: the first
    b maximising m10 cos_b + m01 sin_b (each product rounded, then the sum),
    so zero moments give bin 0."""
    cosb, sinb = (htod(a, m10.device) for a in brief_bin_vectors(n_bins))
    dots = m10[:, None] * cosb[None] + m01[:, None] * sinb[None]   # (K, B)
    mx = dots.max(dim=1, keepdim=True).values
    idx = torch.where(dots >= mx, torch.arange(
        n_bins, dtype=torch.int32, device=m10.device), 127)
    return idx.min(dim=1).values


def steered_brief_t_binned(patches_blur_t, m10, m01,
                           quant: bool | None = None,
                           kind: str | None = None):
    """Bits of TRANSPOSED blurred patches (K, PATCH, PATCH) with the ORB
    paper's 30-bin steering (the function of the reference's binned
    extraction kernel, K12): the bin from the raw moments (`angle_bins`),
    the samples from its row of `brief_bin_tables`, rounded first when
    `brief_quant`."""
    ix, iy = (htod(a.astype(np.int64), m10.device)
              for a in brief_bin_tables(kind=kind))
    b = angle_bins(m10, m01).long()
    vals = _sample(patches_blur_t, (ix * PATCH + iy)[b],
                   brief_quant(quant))                           # (K, 512)
    return (vals[:, :256] < vals[:, 256:]).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _atlas_valid_mask(offsets, total: int, wp: int, shapes, margin: int):
    """Static (HA, WP) mask: True inside each level's interior margin."""
    mask = np.zeros((total, wp), dtype=bool)
    for (off, lh, lw), _ in zip(offsets, shapes):
        if lh > 2 * margin and lw > 2 * margin:
            mask[off + margin: off + lh - margin, margin: lw - margin] = True
    return mask


def top_k_stable(x, k: int):
    """Largest k along the last axis, descending, lowest index first among
    equal values: `jax.lax.top_k` semantics (and `approx_max_k`'s off the
    TPU). Returns (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def atlas_keypoints(imgs, nfeatures: int = 4000, nlevels: int = 12,
                    scale_factor: float = 1.1, fast_threshold: float = 15.0,
                    max_kpts: int = 4096):
    """Atlas, K1 maps and per-level Harris top-k keypoints of frames
    imgs (F, H, W); the atlas is the fused build, or with
    RPE_NO_FUSED_ATLAS set non-empty the per-level pyramid placed by
    `build_atlas`. Returns dict with atlas and blurred (F, HA, WP), layout
    (offsets, total, wp), and (F, max_kpts) keypoint arrays xy_atlas,
    xy_base, level, score, valid in level order."""
    from .atlas import build_atlas, build_atlas_fused
    from .fast import fast_harris_rank_map
    from .pyramid import build_pyramid, level_shapes

    f, h, w = imgs.shape
    dev = imgs.device
    quotas = level_quotas(nfeatures, nlevels, scale_factor)
    if os.environ.get("RPE_NO_FUSED_ATLAS"):
        atlas, (offsets, total, wp) = build_atlas(
            build_pyramid(imgs, nlevels, scale_factor), h, w, nlevels,
            scale_factor)
    else:
        atlas, (offsets, total, wp) = build_atlas_fused(imgs, nlevels,
                                                        scale_factor)
    rank, blurred = fast_harris_rank_map(atlas, float(fast_threshold))

    shapes = tuple(level_shapes(h, w, nlevels, scale_factor))
    mask = _atlas_valid_mask(tuple(offsets), total, wp, shapes, EDGE_MARGIN)
    neg_inf = torch.full((), -torch.inf, dtype=rank.dtype, device=dev)
    rank = torch.where(htod(mask, dev), rank, neg_inf)

    xs_a, xs_b, lvls, scores, valids = [], [], [], [], []
    for l, ((off, lh, lw), quota) in enumerate(zip(offsets, quotas)):
        if quota <= 0 or lh <= 2 * EDGE_MARGIN or lw <= 2 * EDGE_MARGIN:
            continue
        sub = rank[:, off:off + lh].reshape(f, lh * wp)
        vals, flat = top_k_stable(sub, quota)
        valid = vals > -torch.inf
        vy = torch.where(valid, (flat // wp).to(torch.float32),
                         float(EDGE_MARGIN))
        vx = torch.where(valid, (flat % wp).to(torch.float32),
                         float(EDGE_MARGIN))
        scale = scale_factor ** l
        xs_a.append(torch.stack([vx, vy + off], dim=-1))
        xs_b.append(torch.stack([vx, vy], dim=-1) * scale)
        lvls.append(torch.full((f, quota), l, dtype=torch.int32, device=dev))
        scores.append(vals)
        valids.append(valid)

    out = {"xy_atlas": torch.cat(xs_a, dim=1),
           "xy_base": torch.cat(xs_b, dim=1),
           "level": torch.cat(lvls, dim=1),
           "score": torch.cat(scores, dim=1),
           "valid": torch.cat(valids, dim=1)}
    n = out["xy_atlas"].shape[1]
    if n < max_kpts:
        pad = max_kpts - n
        P = torch.nn.functional.pad
        out["xy_atlas"] = P(out["xy_atlas"], (0, 0, 0, pad),
                            value=float(EDGE_MARGIN))
        out["xy_base"] = P(out["xy_base"], (0, 0, 0, pad))
        for k in ("level", "score", "valid"):
            out[k] = P(out[k], (0, pad))
    else:
        out = {k: v[:, :max_kpts] for k, v in out.items()}
    out.update(atlas=atlas, blurred=blurred, layout=(offsets, total, wp))
    return out


def describe_slots(route: str, atlas, blurred, tbl_x0, rel_y, band: int):
    """Descriptor bits (F, S, 256) uint8 and IC angle (F, S) of every slot,
    by extraction route (ops/extract.py `extract_route`). K2 and K12 give
    bits and moments; after K8, K9 or K10 the angle and the steered BRIEF
    bits are computed here, as the reference does after its patch kernels
    (rpe_tpu/ops/orb.py:434-446)."""
    from . import extract as ex

    args = (atlas, blurred, tbl_x0, rel_y, band)
    if route in ("extract_brief", "extract_brief_binned"):
        bits, m10, m01 = ex.extract_brief(
            *args, binned=route == "extract_brief_binned")
        return bits, torch.atan2(m01, m10)
    f, s = tbl_x0.shape[0], tbl_x0.shape[1] * tbl_x0.shape[2]
    if route == "extract_patches":
        raw, blur = ex.extract_patches(*args)
        m10, m01 = ic_moments(raw)
    elif route == "extract_patches_moments":
        blur, m10, m01 = ex.extract_patches_moments(*args)
    elif route == "extract_patches_t":
        blur, m10, m01 = ex.extract_patches_t(*args)
    else:
        raise ValueError(f"unknown extraction route {route!r}")
    angle = torch.atan2(m01, m10)
    brief = steered_brief_t if route == "extract_patches_t" else steered_brief
    bits = brief(blur.reshape(f * s, PATCH, PATCH), angle.reshape(-1))
    return bits.reshape(f, s, 256), angle


def orb_detect_and_describe_atlas(
    imgs,
    nfeatures: int = 4000,
    nlevels: int = 12,
    scale_factor: float = 1.1,
    fast_threshold: float = 15.0,
    max_kpts: int = 4096,
    extract_cap: int | None = None,
    band: int | None = None,
):
    """Atlas ORB for a batch of frames imgs (F, H, W) float32 in [0, 255].

    Returns dict of (F, max_kpts, ...) arrays, keypoints in band-sorted
    order (the reference's order):
      xy (2) float32 level-0 pixel coords, angle float32 radians,
      level int32, score float32 (Harris), bits (256) uint8, valid bool.

    The reference's switches are read at call time: its kernel gates pick
    the extraction route (ops/extract.py `extract_route`), RPE_NO_FUSED_ATLAS
    the atlas build (`atlas_keypoints`), RPE_BRIEF and RPE_BRIEF_QUANT the
    descriptor (`brief_pattern`, `brief_quant`).
    """
    from .atlas import band_tables
    from .extract import extract_route

    route = extract_route()
    kp = atlas_keypoints(imgs, nfeatures, nlevels, scale_factor,
                         fast_threshold, max_kpts)
    _, total, wp = kp["layout"]
    tb = band_tables(total, wp, kp["xy_atlas"], kp["valid"], patch=PATCH,
                     cap=extract_cap, band=band)
    bits_slots, angle_slots = describe_slots(
        route, kp["atlas"], kp["blurred"], tb["tbl_x0"], tb["rel_y"],
        tb["band"])

    order, slot = tb["order"], tb["slot_of_sorted"]
    return {
        "xy": torch.gather(kp["xy_base"], 1,
                           order[..., None].expand(-1, -1, 2)),
        "angle": torch.gather(angle_slots, 1, slot),
        "level": torch.gather(kp["level"], 1, order),
        "score": torch.gather(kp["score"], 1, order),
        "bits": torch.gather(bits_slots, 1,
                             slot[..., None].expand(-1, -1, 256)),
        "valid": tb["valid_sorted"],
    }


def orb_detect_and_describe(
    imgs,
    nfeatures: int = 4000,
    nlevels: int = 12,
    scale_factor: float = 1.1,
    fast_threshold: float = 15.0,
    max_kpts: int = 4096,
    use_atlas: bool = True,
    extract_cap: int | None = None,
    band: int | None = None,
):
    """ORB for a batch of frames imgs (F, H, W) float32 in [0, 255]: the
    atlas path (`orb_detect_and_describe_atlas`) unless `use_atlas` is false
    or RPE_NO_ATLAS is set non-empty, then the per-level path of the
    reference (rpe_tpu/ops/orb.py:488-537), batched over frames: per
    pyramid level with keypoints, K1 and the top-k (ops/fast.py
    `detect_level`), the IC angle of the raw patches and steered BRIEF of
    the reflect-101 blurred level's patches; levels in order, padded to
    `max_kpts`. Same output contract; the per-level path keeps keypoints
    in level order and pads with zeros."""
    if use_atlas and not os.environ.get("RPE_NO_ATLAS"):
        return orb_detect_and_describe_atlas(
            imgs, nfeatures=nfeatures, nlevels=nlevels,
            scale_factor=scale_factor, fast_threshold=fast_threshold,
            max_kpts=max_kpts, extract_cap=extract_cap, band=band)
    from .fast import detect_level
    from .pyramid import build_pyramid, gaussian_blur

    f = imgs.shape[0]
    dev = imgs.device
    quotas = level_quotas(nfeatures, nlevels, scale_factor)
    levels = build_pyramid(imgs, nlevels, scale_factor)
    xs, angs, lvls, scores, bits, valids = [], [], [], [], [], []
    for l, (lvl, quota) in enumerate(zip(levels, quotas)):
        if quota <= 0:
            continue
        h, w = lvl.shape[-2:]
        if h <= 2 * EDGE_MARGIN + 1 or w <= 2 * EDGE_MARGIN + 1:
            continue
        xy, harris, valid = detect_level(lvl, fast_threshold, EDGE_MARGIN,
                                         quota)
        # invalid slots hold flat index 0: park them in the interior so
        # their (masked) patches stay in bounds
        xy = torch.where(valid[..., None], xy, float(EDGE_MARGIN))
        ang = ic_angles(gather_patches(lvl, xy).reshape(-1, PATCH, PATCH))
        blur_p = gather_patches(gaussian_blur(lvl), xy)
        b = steered_brief(blur_p.reshape(-1, PATCH, PATCH), ang)
        xs.append(xy * scale_factor ** l)
        angs.append(ang.reshape(f, quota))
        lvls.append(torch.full((f, quota), l, dtype=torch.int32, device=dev))
        scores.append(harris)
        bits.append(b.reshape(f, quota, 256))
        valids.append(valid)

    out = {"xy": torch.cat(xs, dim=1), "angle": torch.cat(angs, dim=1),
           "level": torch.cat(lvls, dim=1), "score": torch.cat(scores, dim=1),
           "bits": torch.cat(bits, dim=1), "valid": torch.cat(valids, dim=1)}
    n = out["xy"].shape[1]
    if n >= max_kpts:
        return {k: v[:, :max_kpts] for k, v in out.items()}
    pad = max_kpts - n
    return {k: torch.nn.functional.pad(
        v, (0, 0, 0, pad) if v.dim() == 3 else (0, pad))
        for k, v in out.items()}
