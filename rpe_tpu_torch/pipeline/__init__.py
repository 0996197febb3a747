"""Pipeline layer: the estimator, batch processing, evaluation and
orchestration (port of rpe_tpu.pipeline)."""

from .estimator import PoseEstimator, estimate_pair

__all__ = ["PoseEstimator", "estimate_pair"]
