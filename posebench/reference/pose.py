"""Plain reference of the pose layer (RANSAC's output and recoverPose),
float64, judging what the program returned for a pair by what it says.

For a pair the program returns matched points, their validity, an inlier
mask and count, a validity flag and (R, t). The reference holds them to:

  * the matching layer: the points are the matched keypoints' positions
    (`pts1 == xy1[idx1]`), the counts are the masks' sums;
  * RANSAC: the inlier mask is the set of valid matches whose squared
    Sampson distance to E = [t]x R lies under the threshold, and `valid`
    is what the counts make it (>= 5 matches and >= 5 inliers, or the
    zero-motion gate);
  * recoverPose: no other of E's four (R, t) candidates has more
    positive-depth votes over the inliers than the returned one could have
    (the port's first key; votes whose sign rounding decides count for the
    returned pose), and R is a rotation.

and RANSAC's model against the scene: its inliers are not fewer than the
valid matches whose Sampson distance to the ground truth's E lies under the
threshold, but for a share.

Numbers (their limits are the configuration's, limits/<config>.json):
  inlier_gap  the widest relative distance |d2 - thr2| / thr2 of a match
              that the program put on the wrong side of the threshold
  inlier_short the largest share of a pair's ground-truth inliers that
              its inlier count falls short by, (n_truth - n) / n_truth
  rot_gap     the largest entry of |R^T R - I| and |det R - 1|
  pose_off    pairs breaking an exact rule above (a count)
Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

F64 = torch.float64


def normalize(pts, K):
    """Pixel coords (..., N, 2) -> normalized camera coords, K (3, 3)."""
    x = (pts[..., 0] - K[0, 2]) / K[0, 0]
    y = (pts[..., 1] - K[1, 2]) / K[1, 1]
    return torch.stack([x, y], dim=-1)


def skew(t):
    z = torch.zeros((), dtype=t.dtype, device=t.device)
    return torch.stack([
        torch.stack([z, -t[2], t[1]]),
        torch.stack([t[2], z, -t[0]]),
        torch.stack([-t[1], t[0], z])])


def sampson_sq(E, p1, p2):
    """Squared Sampson distance of each correspondence (N,)."""
    one = torch.ones_like(p1[:, :1])
    x1 = torch.cat([p1, one], dim=1)                       # (N, 3)
    x2 = torch.cat([p2, one], dim=1)
    Ex1 = x1 @ E.T
    Etx2 = x2 @ E
    num = (x2 * Ex1).sum(1) ** 2
    den = Ex1[:, 0] ** 2 + Ex1[:, 1] ** 2 + Etx2[:, 0] ** 2 + Etx2[:, 1] ** 2
    return num / (den + 1e-12)


def depths(R, t, p1, p2):
    """Midpoint-method depths (z1, z2) (N,) under pose (R, t), and whether
    each sign is certain: a depth's numerator larger than 1e-5 of the sum
    of its terms' magnitudes, far past float32 rounding (a point with
    almost no parallax has a sign that rounding decides)."""
    one = torch.ones_like(p1[:, :1])
    a = torch.cat([p1, one], dim=1)
    b = torch.cat([p2, one], dim=1) @ R                    # R^T x2
    c = (t @ R)[None]                                      # R^T t
    aa, bb, ab = (a * a).sum(1), (b * b).sum(1), (a * b).sum(1)
    ac, bc = (a * c).sum(1), (b * c).sum(1)
    det = aa * bb - ab * ab + 1e-12
    n1, n2 = -ac * bb + ab * bc, aa * bc - ab * ac
    sure = ((n1.abs() > 1e-5 * ((ac * bb).abs() + (ab * bc).abs()))
            & (n2.abs() > 1e-5 * ((aa * bc).abs() + (ab * ac).abs())))
    return n1 / det, n2 / det, sure


def candidate_votes(R, t, p1, p2, inl):
    """Positive-depth votes over the inliers of E = [t]x R's four (R, t)
    candidates, the given pose first: (R, t), (R, -t), (R', t), (R', -t),
    R' the twisted pair (2 t t^T - I) R. Each as (sure, unsure): the votes
    whose signs are certain and the inliers whose signs rounding decides."""
    tu = t / torch.linalg.vector_norm(t)
    Rt = (2.0 * torch.outer(tu, tu) - torch.eye(3, dtype=F64,
                                                  device=R.device)) @ R
    out = []
    for Rc, tc in ((R, t), (R, -t), (Rt, t), (Rt, -t)):
        z1, z2, sure = depths(Rc, tc, p1, p2)
        pos = (z1 > 0) & (z2 > 0)
        out.append((int((pos & sure & inl).sum()), int((~sure & inl).sum())))
    return out


def judge_pair(pair: dict, K, thr_px: float, truth=None) -> dict:
    """The numbers of one pair. `pair` holds the program's outputs as
    tensors: pts1, pts2 (M, 2), match_valid, inlier_mask (M,), num_matches,
    num_inliers, valid (scalars), R (3, 3), t (3,); and, for the matching
    link, xy1, xy2 (N, 2) of the two frames' keypoints and idx1, idx2,
    mvalid_matcher (M,) of the matcher. `truth` is the scene's (R, unit t)
    of the pair."""
    g = {k: (v.to(F64) if v.is_floating_point() else v)
         for k, v in pair.items()}
    notes = []

    def rule(broken: bool, what: str) -> int:
        if broken:
            notes.append(what)
        return int(broken)

    off = 0
    mv = g["match_valid"].bool()
    inl = g["inlier_mask"].bool()
    # the matching link and the counts
    if "xy1" in g:
        off += rule(not torch.equal(g["xy1"][g["idx1"].long()], g["pts1"]),
                    "pts1 are not the matched keypoints")
        off += rule(not torch.equal(g["xy2"][g["idx2"].long()], g["pts2"]),
                    "pts2 are not the matched keypoints")
        off += rule(not torch.equal(g["mvalid_matcher"].bool(), mv),
                    "match_valid is not the matcher's")
    nm, ni = int(g["num_matches"]), int(g["num_inliers"])
    off += rule(nm != int(mv.sum()), "num_matches")
    off += rule(ni != int(inl.sum()), "num_inliers")
    off += rule(bool((inl & ~mv).any()), "an inlier that is no match")
    p1 = normalize(g["pts1"], K)
    p2 = normalize(g["pts2"], K)
    flow2 = ((g["pts2"] - g["pts1"]) ** 2).sum(1)[mv]
    zero_motion = nm >= 8 and float(flow2.sort().values[(nm - 1) // 2]) < 0.25
    want_valid = (nm >= 5 and ni >= 5) or zero_motion
    off += rule(bool(g["valid"]) != want_valid, "valid")
    R, t = g["R"], g["t"]
    eye = torch.eye(3, dtype=F64, device=R.device)
    rot_gap = max(float((R.T @ R - eye).abs().max()),
                  abs(float(torch.linalg.det(R)) - 1.0))
    inlier_gap = 0.0
    inlier_short = None
    if zero_motion:
        off += rule(not (torch.equal(g["R"], eye)
                         and torch.equal(g["t"], eye[2])),
                    "a static pair's pose is not the identity")
    elif bool(g["valid"]):
        thr = thr_px / (0.5 * (float(K[0, 0]) + float(K[1, 1])))
        thr2 = thr * thr
        if truth is not None:
            Rg, tg = (torch.as_tensor(np.asarray(x), dtype=F64,
                                      device=R.device) for x in truth)
            n_truth = int(((sampson_sq(skew(tg) @ Rg, p1, p2) < thr2)
                           & mv).sum())
            if n_truth > 0:
                inlier_short = (n_truth - int(inl.sum())) / n_truth
        d2 = sampson_sq(skew(t) @ R, p1, p2)
        wrong = ((d2 < thr2) != inl) & mv
        if bool(wrong.any()):
            inlier_gap = float(((d2[wrong] - thr2).abs() / thr2).max())
        votes = candidate_votes(R, t, p1, p2, inl)
        most = votes[0][0] + votes[0][1]
        off += rule(any(v[0] > most for v in votes[1:]),
                    f"recoverPose's choice: votes (certain, unsure) {votes}")
    return {"inlier_gap": inlier_gap, "inlier_short": inlier_short,
            "rot_gap": rot_gap, "pose_off": off, "notes": notes}


def worst(a, b):
    """The larger of two readings, either of which may be None (not read)."""
    return b if a is None else a if b is None else max(a, b)


def control_pair(pair: dict, K, thr_px: float) -> dict:
    """The control of one pair: the program's pose rounded to bfloat16,
    the next precision below the configuration's float32, and its inlier
    mask computed in bfloat16 from bfloat16 coordinates; the rest as the
    program returned it."""
    bf = torch.bfloat16
    c = dict(pair)
    R = pair["R"].to(bf)
    t = pair["t"].to(bf)
    Kb = K.to(bf)
    p1 = normalize(pair["pts1"].to(bf), Kb)
    p2 = normalize(pair["pts2"].to(bf), Kb)
    thr = torch.tensor(thr_px, dtype=bf, device=R.device) / (
        0.5 * (Kb[0, 0] + Kb[1, 1]))
    d2 = sampson_sq(skew(t) @ R, p1, p2)
    mask = (d2 < thr * thr) & pair["match_valid"].bool()
    c.update(R=R.float(), t=t.float(), inlier_mask=mask,
             num_inliers=mask.sum())
    return c


def rotation_error_deg(Ra, Rb) -> float:
    """Geodesic angle in degrees between two rotations."""
    tr = float((Ra.to(F64) * Rb.to(F64)).sum())
    return float(torch.rad2deg(torch.arccos(torch.clamp(
        torch.tensor((tr - 1.0) / 2.0, dtype=F64), -1.0, 1.0))))
