"""Offline chessboard camera calibration (Zhang's method)
(port of rpe_tpu/tools/calibrate.py).

Estimates K and radial distortion (k1, k2) from chessboard corner
observations, with the reference tool's per-image reprojection-error
filtering (threshold 1 px, keep the >= 10 best, recalibrate on the
survivors):
  1. per-view homographies by Hartley-normalised DLT;
  2. closed-form intrinsics from the image-of-the-absolute-conic
     constraints (Zhang 2000, eq. 7-9);
  3. extrinsics per view from H and K;
  4. joint Levenberg-Marquardt over (fx, fy, cx, cy, k1, k2, poses)
     minimising the pixel reprojection error (forward-difference
     Jacobian; the parameter count is tiny).

This is numpy host math on purpose, as in the reference: an offline tool of
a few hundred small solves, with nothing for a card to speed up. It is the
reference's own design, not a CPU fallback of a kernel.

Corner detection takes any (N, 2) pixel corner source; `main` finds corners
with OpenCV (cv2.findChessboardCorners) and exits with the reference's
message when cv2 is not installed.

    python -m rpe_tpu_torch.tools.calibrate --images 'calib/*.png'
"""

from __future__ import annotations

import numpy as np

from ..geometry.vp_refine import _so3_exp_np as so3_exp


def make_object_points(rows: int, cols: int, square_size: float):
    """(rows*cols, 3) planar chessboard corner coordinates (z = 0)."""
    ys, xs = np.mgrid[0:rows, 0:cols]
    pts = np.stack([xs.ravel() * square_size, ys.ravel() * square_size,
                    np.zeros(rows * cols)], axis=1)
    return pts.astype(np.float64)


def _homography_dlt(obj_xy, img_xy):
    """Planar homography via normalized DLT; obj/img (N, 2)."""
    def normalize(p):
        c = p.mean(0)
        s = np.sqrt(2.0) / (np.linalg.norm(p - c, axis=1).mean() + 1e-12)
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])
        ph = np.concatenate([p, np.ones((len(p), 1))], axis=1) @ T.T
        return ph, T

    a, Ta = normalize(obj_xy)
    b, Tb = normalize(img_xy)
    n = len(a)
    A = np.zeros((2 * n, 9))
    A[0::2, 0:3] = a
    A[0::2, 6:9] = -b[:, 0:1] * a
    A[1::2, 3:6] = a
    A[1::2, 6:9] = -b[:, 1:2] * a
    _, _, Vt = np.linalg.svd(A)
    H = Vt[-1].reshape(3, 3)
    H = np.linalg.inv(Tb) @ H @ Ta
    return H / H[2, 2]


def _intrinsics_from_homographies(Hs):
    """Zhang closed form: solve for B = K^-T K^-1 from v_ij constraints."""
    def v(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j],
        ])

    V = []
    for H in Hs:
        V.append(v(H, 0, 1))
        V.append(v(H, 0, 0) - v(H, 1, 1))
    V = np.stack(V)
    _, _, Vt = np.linalg.svd(V)
    b11, b12, b22, b13, b23, b33 = Vt[-1]

    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / (b11 * b22 - b12 * b12)))
    skew = -b12 * fx * fx * fy / lam
    cx = skew * cy / fy - b13 * fx * fx / lam
    return np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]])


def _extrinsics_from_h(K, H):
    Kinv = np.linalg.inv(K)
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    lam = 1.0 / (np.linalg.norm(Kinv @ h1) + 1e-12)
    r1 = lam * (Kinv @ h1)
    r2 = lam * (Kinv @ h2)
    r3 = np.cross(r1, r2)
    t = lam * (Kinv @ h3)
    R = np.stack([r1, r2, r3], axis=1)
    # project to SO(3)
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = U @ np.diag([1, 1, -1]) @ Vt
    return R, t


def _so3_log(R):
    cos = np.clip((np.trace(R) - 1) / 2, -1, 1)
    th = np.arccos(cos)
    if th < 1e-9:
        return np.zeros(3)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return v * th / (2 * np.sin(th))


def project(obj_pts, K, dist, rvec, tvec):
    """Project 3D points with radial distortion (k1, k2)."""
    R = so3_exp(rvec)
    Xc = obj_pts @ R.T + tvec
    x = Xc[:, 0] / Xc[:, 2]
    y = Xc[:, 1] / Xc[:, 2]
    r2 = x * x + y * y
    d = 1.0 + dist[0] * r2 + dist[1] * r2 * r2
    u = K[0, 0] * x * d + K[0, 2]
    v_ = K[1, 1] * y * d + K[1, 2]
    return np.stack([u, v_], axis=1)


def calibrate_camera(obj_points, img_points, image_size, lm_iters: int = 30):
    """Zhang calibration. obj_points/img_points: lists of (N, 3)/(N, 2).

    Returns (rms, K, dist(2,), rvecs, tvecs) — the cv2.calibrateCamera
    return contract (dist truncated to the two radial terms used here).
    """
    Hs = [_homography_dlt(o[:, :2], i) for o, i in zip(obj_points, img_points)]
    K = _intrinsics_from_homographies(Hs)
    K[0, 1] = 0.0  # zero-skew model, like the reference tool
    poses = [_extrinsics_from_h(K, H) for H in Hs]
    rvecs = [_so3_log(R) for R, _ in poses]
    tvecs = [t for _, t in poses]
    dist = np.zeros(2)

    def pack():
        return np.concatenate(
            [[K[0, 0], K[1, 1], K[0, 2], K[1, 2]], dist]
            + [np.concatenate([r, t]) for r, t in zip(rvecs, tvecs)])

    def unpack(p):
        K2 = np.array([[p[0], 0, p[2]], [0, p[1], p[3]], [0, 0, 1.0]])
        d2 = p[4:6]
        rs, ts = [], []
        for i in range(len(obj_points)):
            rs.append(p[6 + 6 * i: 9 + 6 * i])
            ts.append(p[9 + 6 * i: 12 + 6 * i])
        return K2, d2, rs, ts

    def residuals(p):
        K2, d2, rs, ts = unpack(p)
        res = []
        for o, im, r, t in zip(obj_points, img_points, rs, ts):
            res.append((project(o, K2, d2, r, t) - im).ravel())
        return np.concatenate(res)

    # Levenberg-Marquardt with forward-difference Jacobian (tiny parameter
    # count; offline tool).
    p = pack()
    lam = 1e-3
    r = residuals(p)
    cost = float(r @ r)
    for _ in range(lm_iters):
        J = np.zeros((len(r), len(p)))
        for j in range(len(p)):
            dp = np.zeros_like(p)
            dp[j] = 1e-6 * max(1.0, abs(p[j]))
            J[:, j] = (residuals(p + dp) - r) / dp[j]
        H_ = J.T @ J
        g = J.T @ r
        for _ in range(10):
            try:
                step = np.linalg.solve(H_ + lam * np.diag(np.diag(H_) + 1e-12),
                                       -g)
            except np.linalg.LinAlgError:
                lam *= 10
                continue
            p_new = p + step
            r_new = residuals(p_new)
            c_new = float(r_new @ r_new)
            if c_new < cost:
                p, r, cost = p_new, r_new, c_new
                lam = max(lam * 0.3, 1e-9)
                break
            lam *= 10
        if np.linalg.norm(step) < 1e-10:
            break

    K, dist, rvecs, tvecs = unpack(p)
    n_pts = sum(len(i) for i in img_points)
    rms = float(np.sqrt(cost / n_pts))
    return rms, K, dist, rvecs, tvecs


def per_image_errors(obj_points, img_points, K, dist, rvecs, tvecs):
    """Mean reprojection error per image."""
    errs = []
    for o, im, r, t in zip(obj_points, img_points, rvecs, tvecs):
        d = np.linalg.norm(project(o, K, dist, r, t) - im, axis=1)
        errs.append(float(d.mean()))
    return np.array(errs)


def calibrate_with_filtering(obj_points, img_points, image_size,
                             error_threshold: float = 1.0,
                             min_keep: int = 10):
    """The reference tool's workflow: calibrate, drop images with
    reprojection error above threshold (keeping at least `min_keep` best),
    recalibrate on the rest. Returns (rms, K, dist, per-image errors of the
    first calibration, kept mask)."""
    rms, K, dist, rvecs, tvecs = calibrate_camera(
        obj_points, img_points, image_size)
    errs = per_image_errors(obj_points, img_points, K, dist, rvecs, tvecs)
    keep = errs <= error_threshold
    if keep.sum() < min_keep:
        keep = np.zeros_like(keep)
        keep[np.argsort(errs)[:min_keep]] = True
    if keep.all():
        return rms, K, dist, errs, keep
    obj2 = [o for o, k_ in zip(obj_points, keep) if k_]
    img2 = [i for i, k_ in zip(img_points, keep) if k_]
    rms2, K2, dist2, rv2, tv2 = calibrate_camera(obj2, img2, image_size)
    return rms2, K2, dist2, errs, keep


def main(argv=None):
    import argparse
    import glob

    parser = argparse.ArgumentParser(
        description="Chessboard camera calibration (Zhang)")
    parser.add_argument("--images", required=True,
                        help="glob of calibration images")
    parser.add_argument("--rows", type=int, default=7)
    parser.add_argument("--cols", type=int, default=7)
    parser.add_argument("--square-size", type=float, default=0.04)
    parser.add_argument("--output", default="calibration_filtered.npz")
    args = parser.parse_args(argv)

    try:
        import cv2  # corner detection only; calibration math is ours
    except ImportError as e:
        raise SystemExit(
            "corner detection requires OpenCV (cv2); pass pre-detected "
            "corners to calibrate_camera() for a cv2-free path") from e

    obj = make_object_points(args.rows, args.cols, args.square_size)
    obj_points, img_points = [], []
    size = None
    for path in sorted(glob.glob(args.images)):
        gray = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if gray is None:
            continue
        size = (gray.shape[1], gray.shape[0])
        found, corners = cv2.findChessboardCorners(
            gray, (args.cols, args.rows), None)
        if not found:
            print(f"[WARN] no chessboard in {path}")
            continue
        corners = cv2.cornerSubPix(
            gray, corners, (11, 11), (-1, -1),
            (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 0.001))
        obj_points.append(obj)
        img_points.append(corners.reshape(-1, 2).astype(np.float64))
    if len(obj_points) < 3:
        raise SystemExit("need at least 3 usable chessboard images")

    rms, K, dist, errs, keep = calibrate_with_filtering(
        obj_points, img_points, size)
    print(f"[INFO] kept {keep.sum()}/{len(keep)} images, rms = {rms:.4f} px")
    print("[INFO] K =\n", K)
    np.savez(args.output, K=K, dist=np.array([dist[0], dist[1], 0, 0, 0]))
    print(f"[INFO] saved {args.output}")


if __name__ == "__main__":
    main()
