"""Pose recovery from an essential matrix with a batched cheirality test
(port of rpe_tpu/geometry/recover_pose.py).

Conventions match OpenCV: x2 ~ R x1 + t, t unit-norm, points farther than
`dist_thresh` baselines do not count. Functions take E (..., 3, 3) and
points (..., N, 2) whose leading dims broadcast against E's.
"""

from __future__ import annotations

import torch

from ..utils.observability import htod
from ._products import matmuls
from .epipolar import essential_frame

_EPS = 1e-12


def decompose_essential(E):
    """E (..., 3, 3) -> (R1, R2, t): R1 = U W Vt, R2 = U W^T Vt, t = U[:, 2]
    (U, Vt those of `project_to_essential`, whose projection is not formed;
    on the card the products are P2's, R1 and R2 two chains of one
    launch)."""
    U, Vt = essential_frame(E)
    W = htod([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
             E.device, E.dtype)
    R1, R2 = matmuls((U, W, Vt), (U, W.T, Vt))
    return R1, R2, U[..., :, 2]


def triangulate_depths(R, t, pts1_n, pts2_n):
    """Midpoint-method depths (z1, z2) (..., N) of the points under pose
    (R (..., 3, 3), t (..., 3)); pts (..., N, 2) broadcast against R. The
    products are P2's on the card, both in one launch."""
    x1 = torch.cat([pts1_n, torch.ones_like(pts1_n[..., :1])], dim=-1)
    x2 = torch.cat([pts2_n, torch.ones_like(pts2_n[..., :1])], dim=-1)
    # R^T x2 (..., N, 3) and R^T t (..., 1, 3)
    b, c = matmuls((x2, R), (t[..., None, :], R))
    a = x1
    aa = (a * a).sum(-1)
    bb = (b * b).sum(-1)
    ab = (a * b).sum(-1)
    ac = (a * c).sum(-1)
    bc = (b * c).sum(-1)
    det = aa * bb - ab * ab
    z1 = (-ac * bb + ab * bc) / (det + _EPS)
    z2 = (aa * bc - ab * ac) / (det + _EPS)
    return z1, z2


def _four_candidates(E):
    R1, R2, t = decompose_essential(E)
    return (torch.stack([R1, R1, R2, R2], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))


def cheirality_votes(E, pts1_n, pts2_n, valid_mask):
    """Best positive-depth vote count (no distance cap) over E's four
    (R, t) candidates: E (..., 3, 3), valid_mask (..., N) -> (...)."""
    Rs, ts = _four_candidates(E)
    z1, z2 = triangulate_depths(Rs, ts, pts1_n[..., None, :, :],
                                pts2_n[..., None, :, :])
    good = (z1 > 0.0) & (z2 > 0.0) & valid_mask[..., None, :]
    return good.sum(-1, dtype=torch.int32).amax(-1)


def recover_pose(E, pts1_n, pts2_n, valid_mask, dist_thresh=50.0,
                 inlier_mask=None):
    """Cheirality-consistent (R, t) among E's four candidates.

    With `inlier_mask`, candidates rank by uncapped positive-depth votes
    over the inliers first and capped all-match votes second (the
    reference's documented deviation from cv2.recoverPose, PARITY.md).
    Returns (R (..., 3, 3), t (..., 3), votes (...) int32 capped all-match
    votes of the winner, good (..., N) bool).
    """
    Rs, ts = _four_candidates(E)                               # (..., 4, ...)
    z1, z2 = triangulate_depths(Rs, ts, pts1_n[..., None, :, :],
                                pts2_n[..., None, :, :])       # (..., 4, N)
    pos = (z1 > 0.0) & (z2 > 0.0)
    front = pos & (z1 < dist_thresh) & (z2 < dist_thresh)
    good = front & valid_mask[..., None, :]
    votes = good.sum(-1, dtype=torch.int32)                       # (..., 4)
    if inlier_mask is None:
        score = votes
    else:
        n = pts1_n.shape[-2]
        votes_inl = (pos & inlier_mask[..., None, :]).sum(
            -1, dtype=torch.int32)
        score = votes_inl * (n + 1) + votes
    best = torch.argmax(score, dim=-1)                         # (...)
    R = torch.gather(Rs, -3, best[..., None, None, None].expand(
        *best.shape, 1, 3, 3))[..., 0, :, :]
    t = torch.gather(ts, -2, best[..., None, None].expand(
        *best.shape, 1, 3))[..., 0, :]
    v = torch.gather(votes, -1, best[..., None])[..., 0]
    g = torch.gather(good, -2, best[..., None, None].expand(
        *best.shape, 1, good.shape[-1]))[..., 0, :]
    return R, t, v, g
