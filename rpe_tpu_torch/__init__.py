"""rpe_tpu_torch: the PyTorch + CUDA port of rpe_tpu for NVIDIA Hopper.

6-DoF relative camera pose (R, t direction) between image pairs: ORB on the
pyramid atlas or SIFT -> Hamming or L2 cross-check, or the Lowe ratio test
-> 5-point RANSAC with DEGENSAC -> recoverPose, optional vanishing-point
(Manhattan) rotation refinement, and the sequence-evaluation harness
(ground truth, error metrics, trajectories, plots, annotated videos) with
its dataset runners (rpe_tpu_torch.cli). The kernels are hand-written in
CUDA for sm_90a (rpe_tpu_torch/csrc) and built at their first launch.

The flat API exports the same names as rpe_tpu. Beyond the configurations,
they are imported on first use, so `import rpe_tpu_torch` builds no kernel
and needs no card. The package imports torch and numpy only, never jax or
rpe_tpu.
"""

import importlib

from .config import EstimatorConfig, MatcherConfig, OrbConfig, \
    RansacConfig, SiftConfig, VpConfig, profile_config  # noqa: F401

__version__ = "0.1.0"

_LAZY = {
    "PoseEstimationPipeline": ".pipeline.orchestrator",
    "PoseEstimator": ".pipeline.estimator",
    "BatchProcessor": ".pipeline.batch",
    "PoseEvaluator": ".pipeline.evaluator",
    "CameraCalibration": ".pipeline.calibration",
    "GroundTruthLoader": ".pipeline.ground_truth",
    "Visualizer": ".viz.visualizer",
    "estimate_pair": ".pipeline.estimator",
    "estimate_pairs_batched": ".pipeline.estimator",
    "estimate_sequence_batched": ".pipeline.estimator",
    **{name: ".geometry.rotations" for name in (
        "CONVENTION_YUP", "CONVENTION_ZYX", "euler_to_rotation",
        "euler_to_rotation_yup", "euler_to_rotation_zyx",
        "rotation_to_euler", "rotation_to_euler_yup",
        "rotation_to_euler_zyx", "rotation_error",
        "translation_direction_error")},
    "load_image": ".io.image_loader",
    "load_image_pair": ".io.image_loader",
    **{name: ".pipeline.trajectory" for name in (
        "accumulate_trajectory", "ate", "rpe", "umeyama", "gt_scales",
        "load_kitti_poses", "save_kitti_poses")},
}

__all__ = [
    "PoseEstimationPipeline",
    "PoseEstimator",
    "BatchProcessor",
    "PoseEvaluator",
    "CameraCalibration",
    "GroundTruthLoader",
    "Visualizer",
    "estimate_pair",
    "estimate_pairs_batched",
    "estimate_sequence_batched",
    "EstimatorConfig",
    "OrbConfig",
    "SiftConfig",
    "MatcherConfig",
    "RansacConfig",
    "VpConfig",
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
    "load_image",
    "load_image_pair",
    "accumulate_trajectory",
    "ate",
    "rpe",
    "umeyama",
    "gt_scales",
    "load_kitti_poses",
    "save_kitti_poses",
]


def __getattr__(name):
    if name in _LAZY:
        value = getattr(importlib.import_module(_LAZY[name], __name__), name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
