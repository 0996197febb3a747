"""Rotation parameterizations and angular error metrics (port of
rpe_tpu/geometry/rotations.py).

Conventions:
  * "yup": R = Ry(yaw) @ Rx(pitch) @ Rz(roll)   (simulator data)
  * "zyx": R = Rz(yaw) @ Ry(pitch) @ Rx(roll)   (phone / Salah data)

Angles are degrees at the API boundary. The tensor functions work on
leading batch dimensions and are branch-free (`torch.where`). They take
tensors, which keep their dtype and device, or array-likes, which become
float32 tensors: the reference runs without 64-bit mode, so it computes
these in float32 whatever it is given, and pipeline/batch.py relies on the
port doing the same. The `*_np` twins are float64 numpy, for host-side
evaluation (pipeline/evaluator.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

CONVENTION_YUP = "yup"
CONVENTION_ZYX = "zyx"

_EPS = 1e-12


def _t(x):
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), dtype=torch.float32)


def _deg2rad(x):
    return x * (math.pi / 180.0)


def _rad2deg(x):
    return x * (180.0 / math.pi)


def _angles(yaw_deg, pitch_deg, roll_deg):
    y, p, r = torch.broadcast_tensors(
        *(_deg2rad(_t(a)) for a in (yaw_deg, pitch_deg, roll_deg)))
    return torch.cos(y), torch.sin(y), torch.cos(p), torch.sin(p), \
        torch.cos(r), torch.sin(r)


def _rows(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], dim=-2)


# ---------------------------------------------------------------------------
# Euler -> R
# ---------------------------------------------------------------------------

def euler_to_rotation_yup(yaw_deg, pitch_deg, roll_deg):
    """R = Ry(yaw) @ Rx(pitch) @ Rz(roll), Y-up convention: (..., 3, 3)."""
    cy, sy, cp, sp, cr, sr = _angles(yaw_deg, pitch_deg, roll_deg)
    return _rows([
        [cy * cr + sy * sp * sr, -cy * sr + sy * sp * cr, sy * cp],
        [cp * sr, cp * cr, -sp],
        [-sy * cr + cy * sp * sr, sy * sr + cy * sp * cr, cy * cp],
    ])


def euler_to_rotation_zyx(yaw_deg, pitch_deg, roll_deg):
    """R = Rz(yaw) @ Ry(pitch) @ Rx(roll), ZYX camera convention."""
    cy, sy, cp, sp, cr, sr = _angles(yaw_deg, pitch_deg, roll_deg)
    return _rows([
        [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
        [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
        [-sp, cp * sr, cp * cr],
    ])


def euler_to_rotation(yaw_deg, pitch_deg, roll_deg, convention=CONVENTION_YUP):
    if convention == CONVENTION_ZYX:
        return euler_to_rotation_zyx(yaw_deg, pitch_deg, roll_deg)
    return euler_to_rotation_yup(yaw_deg, pitch_deg, roll_deg)


# ---------------------------------------------------------------------------
# R -> Euler
# ---------------------------------------------------------------------------

def rotation_to_euler_yup(R):
    """(..., 3, 3) -> (yaw, pitch, roll) degrees, Y-up convention, with the
    gimbal-lock branch at |R[2,1]| > 0.9999."""
    R = _t(R)
    r21 = R[..., 2, 1]
    pitch = torch.arcsin(torch.clamp(r21, -1.0, 1.0))
    lock = torch.abs(r21) > 0.9999
    yaw_n = torch.atan2(-R[..., 2, 0], R[..., 0, 0])
    roll_n = torch.atan2(R[..., 1, 0], R[..., 1, 1])
    roll_l = torch.atan2(-R[..., 1, 2], R[..., 1, 1])
    yaw = torch.where(lock, torch.zeros_like(yaw_n), yaw_n)
    roll = torch.where(lock, roll_l, roll_n)
    return _rad2deg(yaw), _rad2deg(pitch), _rad2deg(roll)


def rotation_to_euler_zyx(R):
    """(..., 3, 3) -> (yaw, pitch, roll) degrees, ZYX convention, with the
    sy < 1e-6 singularity branch."""
    R = _t(R)
    sy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    singular = sy < 1e-6
    roll_n = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw_n = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    roll_s = torch.atan2(-R[..., 1, 2], R[..., 1, 1])
    pitch = torch.atan2(-R[..., 2, 0], sy)
    roll = torch.where(singular, roll_s, roll_n)
    yaw = torch.where(singular, torch.zeros_like(yaw_n), yaw_n)
    return _rad2deg(yaw), _rad2deg(pitch), _rad2deg(roll)


def rotation_to_euler(R, convention=CONVENTION_YUP):
    if convention == CONVENTION_ZYX:
        return rotation_to_euler_zyx(R)
    return rotation_to_euler_yup(R)


# ---------------------------------------------------------------------------
# so(3) exp / log
# ---------------------------------------------------------------------------

def _hat(w):
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return _rows([[z, -wz, wy], [wz, z, -wx], [-wy, wx, z]])


def so3_exp(w):
    """Rodrigues: (..., 3) -> (..., 3, 3), with Taylor guards near 0."""
    w = _t(w)
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-12
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    K = _hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + A[..., None, None] * K + B[..., None, None] * (K @ K)


def so3_log(R):
    """Inverse Rodrigues: (..., 3, 3) -> (..., 3)."""
    R = _t(R)
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0))
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_t = torch.sin(theta)
    scale = torch.where(torch.abs(sin_t) < 1e-6,
                        0.5 + theta * theta / 12.0,
                        theta / (2.0 * sin_t + _EPS))
    return v * scale[..., None]


# ---------------------------------------------------------------------------
# Error metrics
# ---------------------------------------------------------------------------

def rotation_error(R_est, R_gt):
    """Geodesic error in degrees, arccos((tr(R_est R_gt^T) - 1) / 2) with
    the clip; batched over leading dims. Full-float32 product (TF32 off:
    arccos near 0 amplifies a reduced-precision trace into a floor)."""
    R_est, R_gt = _t(R_est), _t(R_gt)
    R_diff = torch.einsum("...ij,...kj->...ik", R_est, R_gt)
    trace = R_diff[..., 0, 0] + R_diff[..., 1, 1] + R_diff[..., 2, 2]
    return _rad2deg(torch.arccos(torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)))


def _flat3(t):
    if t.ndim >= 2 and t.shape[-1] == 1:
        return t.reshape(*t.shape[:-2], -1)
    return t


def translation_direction_error(t_est, t_gt):
    """Angle in degrees between directions; (..., 3) or (..., 3, 1)."""
    e = _flat3(_t(t_est))
    g = _flat3(_t(t_gt))
    e = e / (torch.linalg.norm(e, dim=-1, keepdim=True) + _EPS)
    g = g / (torch.linalg.norm(g, dim=-1, keepdim=True) + _EPS)
    dot = torch.clamp(torch.sum(e * g, dim=-1), -1.0, 1.0)
    return _rad2deg(torch.arccos(dot))


def wrap_angle_error(error_deg):
    """abs(((e + 180) mod 360) - 180), the mod taking the divisor's sign."""
    return torch.abs(torch.remainder(_t(error_deg) + 180.0, 360.0) - 180.0)


# ---------------------------------------------------------------------------
# float64 numpy twins -- host-side evaluation metrics
# ---------------------------------------------------------------------------

def euler_to_rotation_np(yaw_deg, pitch_deg, roll_deg,
                         convention=CONVENTION_YUP):
    """float64 numpy twin of euler_to_rotation (same closed forms)."""
    y = np.deg2rad(np.asarray(yaw_deg, np.float64))
    p = np.deg2rad(np.asarray(pitch_deg, np.float64))
    r = np.deg2rad(np.asarray(roll_deg, np.float64))
    cy, sy = np.cos(y), np.sin(y)
    cp, sp = np.cos(p), np.sin(p)
    cr, sr = np.cos(r), np.sin(r)
    if convention == CONVENTION_ZYX:
        rows = [
            np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
            np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
            np.stack([-sp, cp * sr, cp * cr], -1),
        ]
    else:
        rows = [
            np.stack([cy * cr + sy * sp * sr, -cy * sr + sy * sp * cr, sy * cp], -1),
            np.stack([cp * sr, cp * cr, -sp], -1),
            np.stack([-sy * cr + cy * sp * sr, sy * sr + cy * sp * cr, cy * cp], -1),
        ]
    return np.stack(rows, axis=-2)


def rotation_error_np(R_est, R_gt):
    """float64 numpy twin of rotation_error."""
    R_est = np.asarray(R_est, np.float64)
    R_gt = np.asarray(R_gt, np.float64)
    R_diff = np.matmul(R_est, np.swapaxes(R_gt, -1, -2))
    trace = R_diff[..., 0, 0] + R_diff[..., 1, 1] + R_diff[..., 2, 2]
    return np.degrees(np.arccos(np.clip((trace - 1.0) * 0.5, -1.0, 1.0)))


def translation_direction_error_np(t_est, t_gt):
    """float64 numpy twin of translation_direction_error."""
    t_est = np.asarray(t_est, np.float64)
    t_gt = np.asarray(t_gt, np.float64)
    if t_est.ndim >= 2 and t_est.shape[-1] == 1:
        t_est = t_est.reshape(*t_est.shape[:-2], -1)
    if t_gt.ndim >= 2 and t_gt.shape[-1] == 1:
        t_gt = t_gt.reshape(*t_gt.shape[:-2], -1)
    e = t_est / (np.linalg.norm(t_est, axis=-1, keepdims=True) + _EPS)
    g = t_gt / (np.linalg.norm(t_gt, axis=-1, keepdims=True) + _EPS)
    dot = np.clip(np.sum(e * g, axis=-1), -1.0, 1.0)
    return np.degrees(np.arccos(dot))
