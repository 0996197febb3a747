"""Multi-view geometry in PyTorch, batched over a leading pair axis:
rotations, epipolar solvers, batched RANSAC, pose recovery (port of
rpe_tpu.geometry)."""

from .epipolar import eight_point, normalize_points, project_to_essential, \
    sampson_error_sq
from .ransac import ransac_essential, sample_minimal_indices
from .recover_pose import decompose_essential, recover_pose, \
    triangulate_depths
from .rotations import CONVENTION_YUP, CONVENTION_ZYX, euler_to_rotation, \
    euler_to_rotation_yup, euler_to_rotation_zyx, rotation_error, \
    rotation_to_euler, rotation_to_euler_yup, rotation_to_euler_zyx, \
    so3_exp, so3_log, translation_direction_error, wrap_angle_error

__all__ = [
    "CONVENTION_YUP",
    "CONVENTION_ZYX",
    "euler_to_rotation",
    "euler_to_rotation_yup",
    "euler_to_rotation_zyx",
    "rotation_to_euler",
    "rotation_to_euler_yup",
    "rotation_to_euler_zyx",
    "rotation_error",
    "translation_direction_error",
    "wrap_angle_error",
    "so3_exp",
    "so3_log",
    "normalize_points",
    "eight_point",
    "project_to_essential",
    "sampson_error_sq",
    "ransac_essential",
    "sample_minimal_indices",
    "decompose_essential",
    "recover_pose",
    "triangulate_depths",
]
