"""Vanishing-point (Manhattan-world) rotation refinement (port of
rpe_tpu/geometry/vp_refine.py).

Line segments (ops/lsd.py) -> pairwise VP voting into a 90x360 lat/lon
accumulator on the Gaussian half-sphere with weight |l1||l2||sin 2theta| ->
VP1 = argmax bin, VP2 = best score on the great circle orthogonal to VP1
(360 x 1-degree scan), VP3 = re-orthogonalized cross product ->
Levenberg-Marquardt on SO(3) minimizing sum_k arccos(delta_k . (R d_k)).

Gating: reliability requires acc_max >= acc_min AND vp2_score >= vp2_min on
BOTH frames; refinement is accepted only when the cost improves by more than
cost_improve_eps, else the geometric R_rel stands.

Two twins, as in the reference:
  * the host twin (numpy, float64; the reference's code): segments and
    voting on the host, the labeling (`ops.lsd._label_regions`) on the
    device the caller names, one device-to-host copy per frame stack;
  * the tensor twin (torch, float32, on the frames' device): labeling,
    segment reductions, voting with threefry draws (`rng.randint`, bit-equal
    to `jax.random.randint`) and the LM, batched over frames, with no host
    synchronisation until the caller reads the results. The reference's
    `*_jit` names are kept for the LM and the cost so that a reader finds
    the counterparts; here they are the tensor twins, not compiled
    functions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import rng
from ..config import VpConfig
from ..ops.lsd import (
    detect_line_segments,
    detect_line_segments_device,
    label_regions_host,
    segments_from_labels,
)
from ..ops.orb import top_k_stable
from ..utils.device import full_precision, resolve_device
from .rotations import so3_exp

_N_LAT, _N_LON = 90, 360


def _so3_exp_np(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def manhattan_dirs_for_frames(frames, K, cfg: VpConfig, device=None):
    """Per-frame Manhattan directions for a whole frame stack at once.

    frames: (F, H, W); returns a list of (Delta | None, ok, dbg) in frame
    order. All F labeling passes run in one call on `device` (the card
    unless the caller asks for the CPU), its labels and magnitudes come back
    in one copy each, and segments and voting run on the host per frame.
    Frame f is seeded with its position f in the stack, as in the
    reference. Numerics are those of estimate_manhattan_dirs.
    """
    frames = np.asarray(frames, dtype=np.float32)
    labels, mag = label_regions_host(frames, device)
    out = []
    for f in range(frames.shape[0]):
        lines = segments_from_labels(labels[f], mag[f])
        out.append(_dirs_from_lines(lines, K, cfg, rng_seed=f))
    return out


def manhattan_dirs_for_frames_device(frames, K, cfg: VpConfig,
                                     max_segments: int = 256, device=None):
    """Tensor twin of `manhattan_dirs_for_frames`: labeling, segment
    reduction AND voting for a whole frame stack on `device`, frame f seeded
    with its position f in the stack; the results come back in one
    device-to-host copy.

    Same list-of-(Delta | None, ok, dbg) contract. Opt-in from the batch
    pipeline via RPE_VP_DEVICE=1 (gate statistics deviate from the host
    twin only in the sampling regime -- see _dirs_from_lines_device)."""
    dev = resolve_device(device)
    full_precision()
    frames = torch.as_tensor(np.asarray(frames, dtype=np.float32), device=dev)
    nf = frames.shape[0]
    segs, valid = detect_line_segments_device(frames,
                                              max_segments=max_segments)
    seeds = torch.arange(nf, device=dev)
    D, ok, st = _dirs_from_lines_device(segs, valid, K, cfg, rng_seed=seeds)
    packed = torch.cat([D.reshape(nf, 9), ok[:, None].float(),
                        st["acc_max"][:, None], st["vp2_score"][:, None],
                        st["num_lines"][:, None].float()], dim=1)
    packed = packed.cpu().numpy()
    out = []
    for f in range(nf):
        nl = int(packed[f, 12])
        dbg = {"num_lines": nl, "acc_max": float(packed[f, 10]),
               "vp2_score": float(packed[f, 11]),
               "lines_used": int(min(nl, cfg.max_lines))}
        okf = bool(packed[f, 9])
        out.append((np.asarray(packed[f, :9].reshape(3, 3), np.float64)
                    if okf else None, okf, dbg))
    return out


def estimate_manhattan_dirs(gray, K, cfg: VpConfig, rng_seed: int = 0,
                            device=None):
    """Extract 3 orthogonal Manhattan directions (camera frame).

    Returns (Delta (3,3) columns = directions | None, ok, debug dict). The
    labeling runs on `device`.
    """
    lines = detect_line_segments(gray, device=device)
    return _dirs_from_lines(lines, K, cfg, rng_seed)


def _dirs_from_lines(lines, K, cfg: VpConfig, rng_seed: int = 0):
    """Voting + VP extraction from (N, 4) segments (host entry point)."""
    dbg = {"num_lines": int(lines.shape[0])}
    if lines.shape[0] < 10:
        return None, False, dbg

    dx = lines[:, 2] - lines[:, 0]
    dy = lines[:, 3] - lines[:, 1]
    lens_all = np.hypot(dx, dy) + 1e-9
    order = np.argsort(-lens_all)[: min(cfg.max_lines, len(lines))]
    lines = lines[order]
    lens = lens_all[order]
    angles = np.arctan2(dy[order], dx[order])

    # homogeneous lines, normalized by the norm of the (a, b) part
    p1 = np.concatenate([lines[:, 0:2], np.ones((len(lines), 1))], axis=1)
    p2 = np.concatenate([lines[:, 2:4], np.ones((len(lines), 1))], axis=1)
    hl = np.cross(p1, p2)
    hl = hl / (np.linalg.norm(hl[:, :2], axis=1, keepdims=True) + 1e-12)

    m = len(lines)
    total_pairs = m * (m - 1) // 2
    if total_pairs <= cfg.max_pairs:
        ii, jj = np.triu_indices(m, k=1)
    else:
        rng = np.random.default_rng(rng_seed)
        a = rng.integers(0, m, size=cfg.max_pairs)
        b = rng.integers(0, m, size=cfg.max_pairs)
        keep = a != b
        ii = np.minimum(a[keep], b[keep])
        jj = np.maximum(a[keep], b[keep])

    # vectorized VP voting
    vp = np.cross(hl[ii], hl[jj])
    finite = np.abs(vp[:, 2]) >= 1e-9
    vp, ii, jj = vp[finite], ii[finite], jj[finite]
    vp_xy = vp[:, :2] / vp[:, 2:3]

    theta = np.abs(angles[ii] - angles[jj])
    theta = np.abs((theta + np.pi) % (2 * np.pi) - np.pi)
    w = lens[ii] * lens[jj] * np.abs(np.sin(2.0 * theta))
    pos = w > 0
    vp_xy, w = vp_xy[pos], w[pos]

    Kinv = np.linalg.inv(K)
    v = np.concatenate([vp_xy, np.ones((len(vp_xy), 1))], axis=1) @ Kinv.T
    v = v / (np.linalg.norm(v, axis=1, keepdims=True) + 1e-12)
    v = np.where(v[:, 2:3] < 0, -v, v)  # half-sphere z > 0

    lat = np.rad2deg(np.arctan2(np.hypot(v[:, 0], v[:, 1]), v[:, 2]))
    lon = (np.rad2deg(np.arctan2(v[:, 1], v[:, 0])) + 360.0) % 360.0
    lat_i = np.clip(lat, 0, _N_LAT - 1).astype(np.int64)
    lon_i = np.clip(lon, 0, _N_LON - 1).astype(np.int64)

    acc = np.zeros((_N_LAT, _N_LON))
    np.add.at(acc, (lat_i, lon_i), w)

    acc_max = float(acc.max())
    dbg["acc_max"] = acc_max
    dbg["lines_used"] = int(m)
    if acc_max <= 0:
        return None, False, dbg

    lat1, lon1 = np.unravel_index(np.argmax(acc), acc.shape)
    lat1r, lon1r = np.deg2rad(lat1 + 0.5), np.deg2rad(lon1 + 0.5)
    v1 = np.array([np.sin(lat1r) * np.cos(lon1r),
                   np.sin(lat1r) * np.sin(lon1r),
                   np.cos(lat1r)])
    v1 /= np.linalg.norm(v1) + 1e-12

    # VP2: best accumulator score on the great circle orthogonal to v1
    tmp = np.array([1.0, 0.0, 0.0])
    if abs(tmp @ v1) > 0.9:
        tmp = np.array([0.0, 1.0, 0.0])
    a = np.cross(v1, tmp)
    a /= np.linalg.norm(a) + 1e-12
    b = np.cross(v1, a)
    b /= np.linalg.norm(b) + 1e-12

    degs = np.deg2rad(np.arange(360.0))
    cands = np.cos(degs)[:, None] * a + np.sin(degs)[:, None] * b  # (360, 3)
    cands /= np.linalg.norm(cands, axis=1, keepdims=True) + 1e-12
    ch = np.where(cands[:, 2:3] < 0, -cands, cands)
    clat = np.rad2deg(np.arctan2(np.hypot(ch[:, 0], ch[:, 1]), ch[:, 2]))
    clon = (np.rad2deg(np.arctan2(ch[:, 1], ch[:, 0])) + 360.0) % 360.0
    scores = acc[np.clip(clat, 0, _N_LAT - 1).astype(int),
                 np.clip(clon, 0, _N_LON - 1).astype(int)]
    best = int(np.argmax(scores))
    best_score = float(scores[best])
    v2 = cands[best]
    dbg["vp2_score"] = best_score
    if best_score <= 0:
        return None, False, dbg

    v3 = np.cross(v1, v2)
    v3 /= np.linalg.norm(v3) + 1e-12
    v2 = np.cross(v3, v1)
    v2 /= np.linalg.norm(v2) + 1e-12
    Delta = np.stack([v1, v2, v3], axis=1)
    return Delta, True, dbg


def vp_cost(R_iw, Delta_cam, D_world):
    """sum_k arccos(delta_k . (R d_k))."""
    u = R_iw @ D_world  # columns
    s = np.clip(np.sum(Delta_cam * u, axis=0), -1.0, 1.0)
    return float(np.sum(np.arccos(s)))


def optimize_rotation_from_vps(R_init, Delta_cam, D_world, cfg: VpConfig,
                               jacobian_sign: float = +1.0):
    """LM on SO(3), the host twin.

    The reference's original LM computes J = -(1/sqrt(1-s^2)) (delta x (Rd)),
    which ascends the cost, so its acceptance gate rejects nearly every
    refinement; the true derivative has the + sign, which is the default
    here as in rpe_tpu (PARITY.md). jacobian_sign=-1.0 reproduces the
    original behaviour.
    """
    R = R_init.copy()
    for _ in range(cfg.iters):
        u = R @ D_world                                  # (3, 3) columns u_k
        s = np.clip(np.sum(Delta_cam * u, axis=0), -1.0, 1.0)
        r = np.arccos(s).reshape(3, 1)
        denom = np.sqrt(np.maximum(1e-12, 1.0 - s * s))  # (3,)
        cross = np.cross(Delta_cam.T, u.T)               # (3, 3) rows
        J = jacobian_sign * (cross / denom[:, None])
        H = J.T @ J + cfg.lm_lambda * np.eye(3)
        g = J.T @ r
        try:
            dw = -np.linalg.solve(H, g).reshape(3)
        except np.linalg.LinAlgError:
            break
        R = _so3_exp_np(dw) @ R
        if np.linalg.norm(dw) < 1e-7:
            break
    return R


def optimize_rotation_from_vps_jit(R_init, Delta_cam, D_world,
                                   iters: int = 12,
                                   lm_lambda: float = 1e-2,
                                   jacobian_sign: float = +1.0):
    """LM on SO(3), the tensor twin of `optimize_rotation_from_vps` (float32
    on the inputs' device; the reference's jitted function of this name).

    Fixed `iters` Levenberg-Marquardt steps; the early stop at
    ||dw|| < 1e-7 becomes a masked freeze, so no step waits for the host.
    The normal equations are solved by Cholesky (H = J^T J + lambda I is
    positive definite), in full float32 (no TF32).
    """
    full_precision()
    R = torch.as_tensor(R_init, dtype=torch.float32)
    dev = R.device
    Dc = torch.as_tensor(Delta_cam, dtype=torch.float32, device=dev)
    Dw = torch.as_tensor(D_world, dtype=torch.float32, device=dev)
    eye = torch.eye(3, dtype=torch.float32, device=dev)
    frozen = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(iters):
        u = R @ Dw                                        # (3, 3) columns
        s = torch.clamp(torch.sum(Dc * u, dim=0), -1.0, 1.0)
        cross = torch.linalg.cross(Dc.T, u.T)             # (3, 3) rows
        # arccos(s) and sqrt(1-s^2) cancel catastrophically in float32 near
        # convergence; arctan2(||delta x u||, s) is the same angle, well
        # conditioned at 0, and ||cross|| is sin(angle)
        sin_ang = torch.linalg.vector_norm(cross, dim=1)
        r = torch.atan2(sin_ang, s)[:, None]              # (3, 1)
        denom = torch.clamp_min(sin_ang, 1e-12)
        J = jacobian_sign * (cross / denom[:, None])
        H = J.T @ J + lm_lambda * eye
        g = J.T @ r
        L, _ = torch.linalg.cholesky_ex(H)
        dw = -torch.cholesky_solve(g, L)[:, 0]
        dw = torch.where(torch.isfinite(dw), dw, 0.0)
        converged = torch.linalg.vector_norm(dw) < 1e-7
        R = torch.where(frozen, R, so3_exp(dw) @ R)
        frozen = frozen | converged
    return R


def _gather_rows(v, idx):
    """v (F, L, ...) indexed along dim 1 by idx (F, P) or (P,)."""
    if idx.dim() == 1:
        return v[:, idx]
    ar = torch.arange(v.shape[0], device=v.device)[:, None]
    return v[ar, idx]


def _dirs_from_lines_device(segs, seg_valid, K, cfg: VpConfig,
                            rng_seed=0):
    """Tensor twin of `_dirs_from_lines`, on the segments' device.

    segs: (M, 4) or (F, M, 4) float32, seg_valid: (M,) or (F, M) bool (from
    ops.lsd.detect_line_segments_device); rng_seed an int or an (F,) tensor.
    Returns (Delta (..., 3, 3) float32, ok (...) bool, stats dict of
    tensors {acc_max, vp2_score, num_lines}).

    Below max_pairs every pair of the top lines votes, as in the host twin.
    Above it, cfg.max_pairs pairs are drawn with replacement (i == j draws
    dropped) with `rng.randint` on PRNGKey(uint32 seed), bit-equal to the
    reference's draws; they differ from the host twin's numpy draws, so
    there the two twins agree in distribution, not per frame.
    """
    full_precision()
    batched = segs.dim() == 3
    segs = torch.as_tensor(segs, dtype=torch.float32)
    if not batched:
        segs, seg_valid = segs[None], seg_valid[None]
    dev = segs.device
    seg_valid = torch.as_tensor(seg_valid, device=dev)
    nf = segs.shape[0]
    Kj = torch.as_tensor(np.asarray(K), dtype=torch.float32, device=dev)

    num_lines = seg_valid.sum(dim=1)

    dx = segs[..., 2] - segs[..., 0]
    dy = segs[..., 3] - segs[..., 1]
    lens_all = torch.where(seg_valid, torch.hypot(dx, dy) + 1e-9, 0.0)

    L = min(int(cfg.max_lines), int(segs.shape[1]))
    lens, order = top_k_stable(lens_all, L)
    lines = torch.gather(segs, 1, order[..., None].expand(nf, L, 4))
    lvalid = lens > 0.0
    angles = torch.atan2(torch.gather(dy, 1, order),
                         torch.gather(dx, 1, order))

    ones = torch.ones((nf, L, 1), dtype=torch.float32, device=dev)
    p1 = torch.cat([lines[..., 0:2], ones], dim=-1)
    p2 = torch.cat([lines[..., 2:4], ones], dim=-1)
    hl = torch.linalg.cross(p1, p2)
    hl = hl / (torch.linalg.vector_norm(hl[..., :2], dim=-1, keepdim=True)
               + 1e-12)

    Kinv = torch.linalg.inv(Kj)

    def vote(ii, jj, pair_ok):
        """(flat accumulator bin, weight) per pair (host-twin math)."""
        vp = torch.linalg.cross(_gather_rows(hl, ii), _gather_rows(hl, jj))
        finite = torch.abs(vp[..., 2]) >= 1e-9
        vp_xy = vp[..., :2] / torch.where(finite[..., None], vp[..., 2:3],
                                          1.0)
        theta = torch.abs(_gather_rows(angles, ii) - _gather_rows(angles, jj))
        # the operands are non-negative: fmod is the reference's floor mod
        theta = torch.abs(torch.fmod(theta + math.pi, 2 * math.pi) - math.pi)
        wt = (_gather_rows(lens, ii) * _gather_rows(lens, jj)
              * torch.abs(torch.sin(2.0 * theta)))
        wt = torch.where(pair_ok & finite, wt, 0.0)
        v = torch.cat([vp_xy, torch.ones_like(vp_xy[..., :1])], dim=-1) \
            @ Kinv.T
        v = v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12)
        v = torch.where(v[..., 2:3] < 0, -v, v)
        lat = torch.atan2(torch.hypot(v[..., 0], v[..., 1]), v[..., 2]) \
            * (180.0 / math.pi)
        lon = torch.fmod(torch.atan2(v[..., 1], v[..., 0]) * (180.0 / math.pi)
                         + 360.0, 360.0)
        lat_i = torch.clamp(lat, 0, _N_LAT - 1).to(torch.int64)
        lon_i = torch.clamp(lon, 0, _N_LON - 1).to(torch.int64)
        return lat_i * _N_LON + lon_i, wt

    # exhaustive regime (total pairs <= max_pairs): all triu pairs
    ii_a, jj_a = (torch.as_tensor(a, device=dev)
                  for a in np.triu_indices(L, k=1))
    bin_a, wa = vote(ii_a, jj_a, lvalid[:, ii_a] & lvalid[:, jj_a])

    # sampled regime: max_pairs with-replacement draws over the live lines
    # (i == j draws dropped; duplicates kept)
    mv_i = torch.clamp(num_lines, 2, L)          # live lines after top-L cut
    seeds = torch.as_tensor(rng_seed, dtype=torch.int64, device=dev)
    seeds = seeds.expand(nf) % 2 ** 32
    keys = torch.stack([torch.zeros_like(seeds), seeds], dim=-1)
    k = rng.split(keys)
    P = int(cfg.max_pairs)
    a = rng.randint(k[:, 0], (P,), 0, mv_i)
    b = rng.randint(k[:, 1], (P,), 0, mv_i)
    bin_s, ws = vote(a, b, (a != b) & _gather_rows(lvalid, a)
                     & _gather_rows(lvalid, b))

    tv = mv_i * (mv_i - 1) // 2
    use_sampled = (tv > P)[:, None]
    wa = torch.where(use_sampled, 0.0, wa)
    ws = torch.where(use_sampled, ws, 0.0)
    nb = _N_LAT * _N_LON
    base = torch.arange(nf, device=dev)[:, None] * nb
    acc = torch.zeros(nf * nb, dtype=torch.float32, device=dev)
    acc.index_add_(0, (bin_a + base).reshape(-1), wa.reshape(-1))
    acc.index_add_(0, (bin_s + base).reshape(-1), ws.reshape(-1))
    acc = acc.reshape(nf, _N_LAT, _N_LON)
    acc_max = acc.reshape(nf, nb).max(dim=1).values

    amax = torch.argmax(acc.reshape(nf, nb), dim=1)
    lat1 = (amax // _N_LON).to(torch.float32)
    lon1 = (amax % _N_LON).to(torch.float32)
    lat1r = (lat1 + 0.5) * (math.pi / 180.0)
    lon1r = (lon1 + 0.5) * (math.pi / 180.0)
    v1 = torch.stack([torch.sin(lat1r) * torch.cos(lon1r),
                      torch.sin(lat1r) * torch.sin(lon1r),
                      torch.cos(lat1r)], dim=-1)
    v1 = v1 / (torch.linalg.vector_norm(v1, dim=-1, keepdim=True) + 1e-12)

    # VP2: best accumulator score on the great circle orthogonal to v1
    ex = torch.tensor([1.0, 0.0, 0.0], device=dev)
    ey = torch.tensor([0.0, 1.0, 0.0], device=dev)
    tmp = torch.where((torch.abs(v1[:, 0]) > 0.9)[:, None], ey, ex)
    a = torch.linalg.cross(v1, tmp)
    a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-12)
    b = torch.linalg.cross(v1, a)
    b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-12)

    degs = torch.arange(360.0, dtype=torch.float32, device=dev) \
        * (math.pi / 180.0)
    cands = (torch.cos(degs)[None, :, None] * a[:, None]
             + torch.sin(degs)[None, :, None] * b[:, None])  # (F, 360, 3)
    cands = cands / (torch.linalg.vector_norm(cands, dim=-1, keepdim=True)
                     + 1e-12)
    ch = torch.where(cands[..., 2:3] < 0, -cands, cands)
    clat = torch.atan2(torch.hypot(ch[..., 0], ch[..., 1]), ch[..., 2]) \
        * (180.0 / math.pi)
    clon = torch.fmod(torch.atan2(ch[..., 1], ch[..., 0]) * (180.0 / math.pi)
                      + 360.0, 360.0)
    cbin = (torch.clamp(clat, 0, _N_LAT - 1).to(torch.int64) * _N_LON
            + torch.clamp(clon, 0, _N_LON - 1).to(torch.int64))
    scores = torch.gather(acc.reshape(nf, nb), 1, cbin)
    best = torch.argmax(scores, dim=1)
    vp2_score = torch.gather(scores, 1, best[:, None])[:, 0]
    v2 = torch.gather(cands, 1, best[:, None, None].expand(nf, 1, 3))[:, 0]

    v3 = torch.linalg.cross(v1, v2)
    v3 = v3 / (torch.linalg.vector_norm(v3, dim=-1, keepdim=True) + 1e-12)
    v2 = torch.linalg.cross(v3, v1)
    v2 = v2 / (torch.linalg.vector_norm(v2, dim=-1, keepdim=True) + 1e-12)
    Delta = torch.stack([v1, v2, v3], dim=-1)

    ok = (num_lines >= 10) & (acc_max > 0.0) & (vp2_score > 0.0)
    stats = {"acc_max": acc_max, "vp2_score": vp2_score,
             "num_lines": num_lines}
    if not batched:
        return Delta[0], ok[0], {k_: v[0] for k_, v in stats.items()}
    return Delta, ok, stats


def estimate_manhattan_dirs_device(gray, K, cfg: VpConfig,
                                   max_segments: int = 256,
                                   rng_seed=0):
    """Tensor twin of `estimate_manhattan_dirs` on the frame's device:
    labeling -> segment reduction -> voting (sampled above cfg.max_pairs,
    seeded by `rng_seed`). gray may be (H, W) or (F, H, W) with an (F,)
    tensor of seeds."""
    segs, valid = detect_line_segments_device(gray,
                                              max_segments=max_segments)
    return _dirs_from_lines_device(segs, valid, K, cfg, rng_seed=rng_seed)


def vp_cost_jit(R_iw, Delta_cam, D_world):
    """Tensor twin of `vp_cost` (arctan2 form: same angle, well-conditioned
    near 0 -- see optimize_rotation_from_vps_jit)."""
    u = R_iw @ D_world
    s = torch.clamp(torch.sum(Delta_cam * u, dim=0), -1.0, 1.0)
    sin_ang = torch.linalg.vector_norm(
        torch.linalg.cross(Delta_cam.T, u.T), dim=1)
    return torch.sum(torch.atan2(sin_ang, s))


def refine_rotation_with_vps_device(img1, img2, R_prev, R_rel, K,
                                    cfg: VpConfig,
                                    max_segments: int = 256, device=None):
    """Gated VP refinement as tensors on `device` (the card unless the
    caller asks for the CPU): the two frames go through one batched
    labeling and voting (seeds 0 and 1, per role, as in the reference).

    Same acceptance semantics as `refine_rotation_with_vps`: both frames
    must pass the reliability gates AND the optimized cost must improve by
    more than cost_improve_eps, else R_rel passes through unchanged; the
    decision is a `torch.where`, so nothing waits for the host.

    Returns (R_rel_out (3,3), used (bool tensor), stats dict of tensors).
    """
    dev = resolve_device(device)
    full_precision()
    R_prev = torch.as_tensor(np.asarray(R_prev), dtype=torch.float32,
                             device=dev)
    R_rel = torch.as_tensor(np.asarray(R_rel), dtype=torch.float32,
                            device=dev)
    R_new_init = R_prev @ R_rel

    frames = torch.as_tensor(
        np.stack([np.asarray(img1), np.asarray(img2)]).astype(np.float32),
        device=dev)
    D, ok, st = estimate_manhattan_dirs_device(
        frames, K, cfg, max_segments=max_segments,
        rng_seed=torch.arange(2, device=dev))
    good = ok & (st["acc_max"] >= cfg.acc_min) \
        & (st["vp2_score"] >= cfg.vp2_min)
    Delta_prev, Delta_new = D[0], D[1]

    D_world = R_prev.T @ Delta_prev
    cost_init = vp_cost_jit(R_new_init, Delta_new, D_world)
    R_opt = optimize_rotation_from_vps_jit(R_new_init, Delta_new, D_world,
                                           iters=cfg.iters,
                                           lm_lambda=cfg.lm_lambda)
    cost_opt = vp_cost_jit(R_opt, Delta_new, D_world)

    used = good[0] & good[1] & (cost_opt < cost_init - cfg.cost_improve_eps)
    R_out = torch.where(used, R_prev.T @ R_opt, R_rel)
    stats = {"prev_acc_max": st["acc_max"][0], "new_acc_max": st["acc_max"][1],
             "prev_vp2": st["vp2_score"][0], "new_vp2": st["vp2_score"][1],
             "cost_init": cost_init, "cost_opt": cost_opt}
    return R_out, used, stats


def refine_rotation_with_vps(img1, img2, R_prev, R_rel, K, cfg: VpConfig,
                             device=None):
    """Full gated refinement, the host twin (labeling on `device`).

    Returns (R_rel_out, used, debug). R_rel is returned unchanged unless both
    frames pass the reliability gates AND the optimized cost improves by more
    than cost_improve_eps.
    """
    R_new_init = R_prev @ R_rel
    Delta_prev, ok1, dbg1 = estimate_manhattan_dirs(img1, K, cfg, rng_seed=0,
                                                    device=device)
    Delta_new, ok2, dbg2 = estimate_manhattan_dirs(img2, K, cfg, rng_seed=1,
                                                   device=device)

    dbg = {"prev_frame": dbg1, "new_frame": dbg2,
           "vp_extracted": ok1 and ok2}
    good1 = ok1 and dbg1.get("acc_max", 0.0) >= cfg.acc_min \
        and dbg1.get("vp2_score", 0.0) >= cfg.vp2_min
    good2 = ok2 and dbg2.get("acc_max", 0.0) >= cfg.acc_min \
        and dbg2.get("vp2_score", 0.0) >= cfg.vp2_min
    dbg["reliability"] = {"prev_reliable": good1, "new_reliable": good2}
    if not (good1 and good2):
        return R_rel, False, dbg

    D_world = R_prev.T @ Delta_prev
    cost_init = vp_cost(R_new_init, Delta_new, D_world)
    R_opt = optimize_rotation_from_vps(R_new_init, Delta_new, D_world, cfg)
    cost_opt = vp_cost(R_opt, Delta_new, D_world)
    dbg["optimization"] = {
        "cost_init": cost_init,
        "cost_opt": cost_opt,
        "cost_improved": cost_opt < cost_init - cfg.cost_improve_eps,
    }
    if cost_opt < cost_init - cfg.cost_improve_eps:
        return R_prev.T @ R_opt, True, dbg
    return R_rel, False, dbg
