"""Trajectory accumulation and ATE/RPE evaluation (port of
rpe_tpu/pipeline/trajectory.py; float64 numpy on the host).

- `accumulate_trajectory`: chain per-pair relative poses (the estimator's
  x2 = R x1 + t convention) into absolute camera-to-world poses. Monocular
  translation is direction-only; pass per-pair `scales` (e.g. `gt_scales`)
  to resolve it, as standard for mono odometry evaluation.
- `load_kitti_poses` / `save_kitti_poses`: KITTI odometry ground-truth
  format (one 3x4 row-major camera-to-world matrix per line).
- `umeyama`: closed-form similarity alignment (Umeyama 1991), used by ATE.
- `ate`: absolute trajectory error after sim3/se3/no alignment.
- `rpe`: relative pose error over a frame delta (TUM-RGBD definition).

It runs once per sequence, and float32 accumulation over hundreds of 4x4
chains visibly drifts, so it stays float64 numpy.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "accumulate_trajectory",
    "ate",
    "gt_scales",
    "load_kitti_poses",
    "rpe",
    "save_kitti_poses",
    "umeyama",
]


def _to_se3(poses):
    """(N, 3, 4) or (N, 4, 4) -> (N, 4, 4) float64."""
    poses = np.asarray(poses, dtype=np.float64)
    if poses.ndim != 3 or poses.shape[1:] not in ((3, 4), (4, 4)):
        raise ValueError(f"expected (N,3,4) or (N,4,4) poses, got {poses.shape}")
    if poses.shape[1] == 3:
        bottom = np.zeros((poses.shape[0], 1, 4))
        bottom[:, 0, 3] = 1.0
        poses = np.concatenate([poses, bottom], axis=1)
    return poses


def _inv_se3(T):
    """Batched SE(3) inverse without np.linalg.inv (exact for rigid T)."""
    T = np.asarray(T, dtype=np.float64)
    R = T[..., :3, :3]
    t = T[..., :3, 3:]
    Rt = np.swapaxes(R, -1, -2)
    out = np.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3:] = -Rt @ t
    out[..., 3, 3] = 1.0
    return out


def accumulate_trajectory(R_rel, t_rel, scales=None, valid=None, T0=None):
    """Chain relative pair poses into absolute camera-to-world poses.

    Args:
      R_rel: (N, 3, 3) rotations with x2 = R x1 + t (cam_{i+1} from cam_i,
        the estimator's convention).
      t_rel: (N, 3) or (N, 3, 1) unit translation directions.
      scales: optional (N,) metric scale per pair (monocular t is
        direction-only). Default 1.0.
      valid: optional (N,) bool; invalid pairs contribute identity motion
        (the masked-failure contract — a failed pair must not NaN the
        whole trajectory).
      T0: optional (4, 4) starting pose (default identity).

    Returns (N+1, 4, 4) camera-to-world poses, the first being T0.
    """
    R_rel = np.asarray(R_rel, dtype=np.float64)
    t_rel = np.asarray(t_rel, dtype=np.float64).reshape(R_rel.shape[0], 3)
    n = R_rel.shape[0]
    s = np.ones(n) if scales is None else np.asarray(scales, dtype=np.float64)
    T = np.eye(4) if T0 is None else np.asarray(T0, dtype=np.float64).copy()
    out = np.empty((n + 1, 4, 4))
    out[0] = T
    for i in range(n):
        if valid is None or bool(valid[i]):
            # T_w_c2 = T_w_c1 @ inv([R|s*t]) = T_w_c1 @ [R^T | -R^T s t]
            step = np.eye(4)
            step[:3, :3] = R_rel[i].T
            step[:3, 3] = -R_rel[i].T @ (s[i] * t_rel[i])
            T = T @ step
        out[i + 1] = T
    return out


def gt_scales(gt_poses):
    """(N, 4, 4) GT camera-to-world poses -> (N-1,) per-pair baseline norms.

    The standard monocular scale resolution: each estimated unit direction
    is stretched to the ground-truth step length.
    """
    p = _to_se3(gt_poses)[:, :3, 3]
    return np.linalg.norm(np.diff(p, axis=0), axis=-1)


def load_kitti_poses(path):
    """KITTI odometry pose file -> (N, 4, 4) camera-to-world float64.

    Format: one line per frame, 12 space-separated floats, the row-major
    3x4 [R|t] mapping camera coordinates into the world (first) frame.
    """
    data = np.loadtxt(path, dtype=np.float64)
    data = np.atleast_2d(data)
    if data.shape[1] != 12:
        raise ValueError(f"expected 12 columns in KITTI pose file, got "
                         f"{data.shape[1]}")
    return _to_se3(data.reshape(-1, 3, 4))


def save_kitti_poses(path, poses):
    """Write (N, 4, 4) or (N, 3, 4) poses in KITTI odometry format."""
    poses = _to_se3(poses)
    np.savetxt(path, poses[:, :3, :].reshape(len(poses), 12), fmt="%.9e")


def umeyama(src, dst, with_scale=True):
    """Least-squares similarity aligning src points onto dst (Umeyama 1991).

    Args:
      src, dst: (N, 3) point sets.
      with_scale: solve sim(3) when True, se(3) (scale=1) when False.

    Returns (s, R, t) minimizing sum ||dst_i - (s R src_i + t)||^2.
    """
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    if src.shape != dst.shape or src.ndim != 2 or src.shape[1] != 3:
        raise ValueError(f"point sets must both be (N,3), got {src.shape} "
                         f"vs {dst.shape}")
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = (xs * xs).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if (with_scale and var_s > 0) \
        else 1.0
    t = mu_d - s * (R @ mu_s)
    return s, R, t


def _stats(err):
    err = np.asarray(err, dtype=np.float64)
    return {
        "rmse": float(np.sqrt(np.mean(err * err))),
        "mean": float(np.mean(err)),
        "median": float(np.median(err)),
        "std": float(np.std(err)),
        "max": float(np.max(err)),
        "min": float(np.min(err)),
    }


def ate(est_poses, gt_poses, align="sim3"):
    """Absolute trajectory error of est vs gt positions after alignment.

    Args:
      est_poses, gt_poses: (N, 4, 4) / (N, 3, 4) pose chains, or (N, 3)
        position arrays.
      align: "sim3" (scale+rigid, the monocular default), "se3" (rigid),
        or "none".

    Returns dict: rmse/mean/median/std/max/min of per-frame position error,
    plus "aligned_positions" (N, 3) and the alignment (s, R, t).
    """
    def positions(p):
        p = np.asarray(p, dtype=np.float64)
        return p if (p.ndim == 2 and p.shape[1] == 3) else _to_se3(p)[:, :3, 3]

    pe = positions(est_poses)
    pg = positions(gt_poses)
    if len(pe) != len(pg):
        raise ValueError(f"trajectory length mismatch: {len(pe)} vs {len(pg)}")
    if align == "none":
        s, R, t = 1.0, np.eye(3), np.zeros(3)
    elif align in ("sim3", "se3"):
        s, R, t = umeyama(pe, pg, with_scale=(align == "sim3"))
    else:
        raise ValueError(f"unknown align mode {align!r}")
    pa = (s * (R @ pe.T)).T + t
    out = _stats(np.linalg.norm(pa - pg, axis=-1))
    out["aligned_positions"] = pa
    out["alignment"] = (s, R, t)
    return out


def rpe(est_poses, gt_poses, delta=1):
    """Relative pose error over a frame delta (TUM-RGBD definition).

    E_i = (Q_i^-1 Q_{i+d})^-1 (P_i^-1 P_{i+d}) with Q ground truth, P
    estimate; translational error is ||trans(E_i)||, rotational error the
    geodesic angle of rot(E_i).

    Returns dict with "trans" and "rot_deg" stat sub-dicts plus the raw
    per-index error arrays.
    """
    P = _to_se3(est_poses)
    Q = _to_se3(gt_poses)
    if len(P) != len(Q):
        raise ValueError(f"trajectory length mismatch: {len(P)} vs {len(Q)}")
    if not (1 <= delta < len(P)):
        raise ValueError(f"delta {delta} out of range for {len(P)} poses")
    dP = _inv_se3(P[:-delta]) @ P[delta:]
    dQ = _inv_se3(Q[:-delta]) @ Q[delta:]
    E = _inv_se3(dQ) @ dP
    t_err = np.linalg.norm(E[:, :3, 3], axis=-1)
    tr = np.clip((np.trace(E[:, :3, :3], axis1=1, axis2=2) - 1.0) * 0.5,
                 -1.0, 1.0)
    r_err = np.degrees(np.arccos(tr))
    return {
        "trans": _stats(t_err),
        "rot_deg": _stats(r_err),
        "trans_errors": t_err,
        "rot_errors_deg": r_err,
    }
