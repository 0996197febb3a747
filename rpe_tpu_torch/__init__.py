"""rpe_tpu_torch: the PyTorch + CUDA port of rpe_tpu for NVIDIA Hopper.

It covers the sequence pose path: ORB on the pyramid atlas or SIFT ->
Hamming or L2 cross-check, or the Lowe ratio test -> 5-point RANSAC with
DEGENSAC -> recoverPose, with its kernels hand-written in CUDA for sm_90a
(rpe_tpu_torch/csrc). Entry points: rpe_tpu_torch.pipeline.estimator; for
whole sequences from disk, rpe_tpu_torch.pipeline.batch.BatchProcessor and
the KITTI runner rpe_tpu_torch.cli.run_kitti_sequence. The package imports
torch and numpy only, never jax or rpe_tpu.
"""

from .config import EstimatorConfig, MatcherConfig, OrbConfig, \
    RansacConfig, SiftConfig, profile_config

__all__ = ["EstimatorConfig", "MatcherConfig", "OrbConfig", "RansacConfig",
           "SiftConfig", "profile_config"]
