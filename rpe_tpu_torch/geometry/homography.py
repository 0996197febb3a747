"""Homography estimation + plane-degeneracy rescue, DEGENSAC-style
(port of rpe_tpu/geometry/homography.py).

When a homography explains most of the winning E's support (or GRIC
prefers H over E), E is re-estimated from the plane plus pairs of
off-plane points (F = [e']_x H) and adopted if its off-plane support wins.
Every function carries a leading pair axis P; keys are (P, 2).
"""

from __future__ import annotations

import math

import torch

from .. import rng
from ._products import matmul, matmuls, row_sum
from .eig import _cross, smallest_eigvec_sym
from .epipolar import normal_matrix, project_to_essential, \
    sampson_error_sq

_EPS = 1e-12


def _build_dlt_rows(pts1, pts2):
    """DLT rows for x2 ~ H x1: (..., N, 2) x2 -> (..., 2N, 9)."""
    x, y = pts1[..., 0], pts1[..., 1]
    u, v = pts2[..., 0], pts2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([-x, -y, -o, z, z, z, u * x, u * y, u], dim=-1)
    r2 = torch.stack([z, z, z, -x, -y, -o, v * x, v * y, v], dim=-1)
    return torch.cat([r1, r2], dim=-2)


def dlt_homography(pts1, pts2, weights=None):
    """Weighted DLT homography (..., N, 2) x2 -> (..., 3, 3). The weights
    are repeated element-wise over the 2N rows, as the reference does."""
    A = _build_dlt_rows(pts1, pts2)
    if weights is not None:
        A = A * torch.repeat_interleave(weights, 2, dim=-1)[..., None]
    h = smallest_eigvec_sym(normal_matrix(A))
    return h.reshape(*h.shape[:-1], 3, 3)


def homography_transfer_err_sq(H, pts1, pts2):
    """Forward transfer error |proj(H x1) - x2|^2: H (..., 3, 3), pts
    (..., N, 2) -> (..., N); projections at infinity are misses (inf)."""
    x, y = pts1[..., 0], pts1[..., 1]

    def h(i, j):
        return H[..., i, j, None]

    px = h(0, 0) * x + h(0, 1) * y + h(0, 2)
    py = h(1, 0) * x + h(1, 1) * y + h(1, 2)
    pw = h(2, 0) * x + h(2, 1) * y + h(2, 2)
    far = pw.abs() > _EPS
    inv = torch.where(far, 1.0 / pw, 0.0)
    du = px * inv - pts2[..., 0]
    dv = py * inv - pts2[..., 1]
    err = du * du + dv * dv
    return torch.where(far, err, torch.inf)


def _rank(x):
    """Rank of each entry along the last axis (stable double argsort)."""
    return torch.argsort(torch.argsort(x, dim=-1, stable=True), dim=-1,
                         stable=True)


def _take(x, idx):
    """x (P, H, ...) at idx (P,) -> (P, ...)."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def ransac_homography(key, pts1_n, pts2_n, valid_mask, threshold_n,
                      num_hypotheses: int = 64):
    """Batched-hypothesis homography RANSAC + one weighted refit.
    Returns (H (P, 3, 3), inlier_mask (P, N), num_inliers (P,))."""
    from .ransac import gather_points, sample_minimal_indices

    idx = sample_minimal_indices(key, valid_mask, num_hypotheses,
                                 sample_size=4)
    s1 = gather_points(pts1_n, idx)
    s2 = gather_points(pts2_n, idx)
    Hh = dlt_homography(s1, s2)                              # (P, H, 3, 3)

    thr2 = (threshold_n * threshold_n)[:, None, None]
    d2 = homography_transfer_err_sq(Hh, pts1_n[:, None], pts2_n[:, None])
    d2 = torch.where(torch.isfinite(d2), d2, thr2)
    inl = (d2 < thr2) & valid_mask[:, None]
    counts = inl.to(torch.int64).sum(-1)
    trunc = (torch.minimum(d2, thr2) * valid_mask[:, None]).sum(-1)
    best = torch.argmax(counts * num_hypotheses - _rank(trunc), dim=-1)

    H_best = _take(Hh, best)
    mask = _take(inl, best)
    H_new = dlt_homography(pts1_n, pts2_n, weights=mask.to(pts1_n.dtype))
    thr2 = thr2[:, 0]
    d2n = homography_transfer_err_sq(H_new, pts1_n, pts2_n)
    d2n = torch.where(torch.isfinite(d2n), d2n, thr2)
    mask_new = (d2n < thr2) & valid_mask
    better = mask_new.sum(-1) >= mask.sum(-1)
    enough = mask.sum(-1) >= 4
    take = better & enough
    H_best = torch.where(take[:, None, None], H_new, H_best)
    mask = torch.where(take[:, None], mask_new, mask)
    return H_best, mask, mask.sum(-1, dtype=torch.int32)


def gric_score(d2, valid_mask, sigma2, d_dim: float, k_par: float):
    """Torr's GRIC over the last axis (lower is better): rho(e^2/sigma^2)
    summed + d n log r + k log(r n), r = 4. The float sum is P2's on the
    card."""
    r = 4.0
    n = valid_mask.to(d2.dtype).sum(-1)
    rho = torch.clamp_max(d2 / sigma2[..., None], 2.0 * (r - d_dim))
    return (row_sum(torch.where(valid_mask, rho, 0.0))
            + d_dim * n * math.log(r) + k_par * torch.log(r * n + _EPS))


def _skew(e):
    z = torch.zeros_like(e[..., 0])
    return torch.stack([
        torch.stack([z, -e[..., 2], e[..., 1]], dim=-1),
        torch.stack([e[..., 2], z, -e[..., 0]], dim=-1),
        torch.stack([-e[..., 1], e[..., 0], z], dim=-1),
    ], dim=-2)


def plane_parallax_essentials(key, H, pts1_n, pts2_n, offplane_mask,
                              num_hypotheses: int = 64):
    """Essential candidates F = [e']_x H with the epipole e' pinned by pairs
    of off-plane correspondences. Returns (E (P, Q, 3, 3), ok (P, Q)). The
    products are P2's on the card (the two lines' in one launch)."""
    from .ransac import gather_points, sample_minimal_indices

    idx = sample_minimal_indices(key, offplane_mask, num_hypotheses,
                                 sample_size=2)

    def h1(p):
        return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)

    xa1 = h1(gather_points(pts1_n, idx[..., 0]))              # (P, Q, 3)
    xa2 = h1(gather_points(pts2_n, idx[..., 0]))
    xb1 = h1(gather_points(pts1_n, idx[..., 1]))
    xb2 = h1(gather_points(pts2_n, idx[..., 1]))
    Ht = H.transpose(-1, -2)[:, None]
    ha, hb = matmuls((xa1[..., None, :], Ht), (xb1[..., None, :], Ht))
    la = _cross(ha[..., 0, :], xa2)
    lb = _cross(hb[..., 0, :], xb2)
    e = _cross(la, lb)
    en = torch.linalg.vector_norm(e, dim=-1)
    ok = torch.isfinite(en) & (en > 1e-9)
    e = e / (en[..., None] + _EPS)
    F = matmul(_skew(e), H[:, None])
    E, _, _ = project_to_essential(F)
    return E, ok & torch.isfinite(E).all(-1).all(-1)


def degensac_rescue(key, E_best, inlier_mask, num_inliers,
                    pts1_n, pts2_n, valid_mask, threshold_n,
                    h_hypotheses: int = 64, pp_hypotheses: int = 64,
                    h_frac: float = 0.8, min_offplane: int = 8):
    """Dominant-plane test + plane-and-parallax re-estimation, per pair.
    Returns (E, inlier_mask, num_inliers, used (bool), h_count)."""
    thr = threshold_n
    thr2 = (thr * thr)[:, None]
    keys = rng.split(key)
    kH, kPP = keys[:, 0], keys[:, 1]

    H, h_mask, h_cnt = ransac_homography(kH, pts1_n, pts2_n, inlier_mask,
                                         thr, num_hypotheses=h_hypotheses)

    sigma2 = (thr / 2.0) ** 2
    d2_E = sampson_error_sq(E_best, pts1_n, pts2_n)
    d2_E = torch.where(torch.isfinite(d2_E), d2_E, 16.0 * sigma2[:, None])
    errh_all = homography_transfer_err_sq(H, pts1_n, pts2_n)
    d2_H = torch.where(torch.isfinite(errh_all), errh_all,
                       16.0 * sigma2[:, None])
    g_E = gric_score(d2_E, valid_mask, sigma2, d_dim=3.0, k_par=5.0)
    g_H = gric_score(d2_H, valid_mask, sigma2, d_dim=2.0, k_par=8.0)
    degen = ((h_cnt.to(torch.float32)
              >= h_frac * num_inliers.to(torch.float32)) | (g_H < g_E))
    dh = torch.where(torch.isfinite(errh_all), torch.sqrt(errh_all),
                     torch.inf)
    off = valid_mask & (dh > 2.0 * thr[:, None])
    n_off = off.sum(-1, dtype=torch.int32)

    E_pp, ok_pp = plane_parallax_essentials(kPP, H, pts1_n, pts2_n, off,
                                            num_hypotheses=pp_hypotheses)
    thr2q = thr2[:, None]
    d2 = sampson_error_sq(E_pp, pts1_n[:, None], pts2_n[:, None])
    d2 = torch.where(torch.isfinite(d2), d2, thr2q)
    inl = (d2 < thr2q) & valid_mask[:, None] & ok_pp[..., None]
    cnt_off = (inl & off[:, None]).to(torch.int64).sum(-1)
    trunc_off = (torch.minimum(d2, thr2q) * off[:, None]).sum(-1)
    best = torch.argmax(cnt_off * pp_hypotheses - _rank(trunc_off), dim=-1)

    d2_cur = sampson_error_sq(E_best, pts1_n, pts2_n)
    d2_cur = torch.where(torch.isfinite(d2_cur), d2_cur, thr2)
    cnt_off_cur = ((d2_cur < thr2) & off).to(torch.int64).sum(-1)

    use = (degen & (num_inliers >= 8) & (h_cnt >= 4)
           & (n_off >= min_offplane) & (_take(cnt_off, best) > cnt_off_cur))
    E_out = torch.where(use[:, None, None], _take(E_pp, best), E_best)
    mask_out = torch.where(use[:, None], _take(inl, best), inlier_mask)
    return (E_out, mask_out, mask_out.sum(-1, dtype=torch.int32), use, h_cnt)
