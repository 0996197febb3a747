"""Pose evaluation against ground truth (port of
rpe_tpu/pipeline/evaluator.py; float64 numpy on the host, no pandas).

The metric definitions are the parity contract: per-axis absolute angle
errors wrapped via abs(((e+180) mod 360) - 180); geodesic rotation error
against the GT absolute rotation; translation *direction* error of the
estimated t against the GT position delta between consecutive evaluated
frames, the first frame's fixed at 0.0.
"""

from __future__ import annotations

import numpy as np

from ..geometry.rotations import (
    euler_to_rotation_np,
    rotation_error_np,
    translation_direction_error_np,
)

_METRICS = ["roll_error", "pitch_error", "yaw_error", "rotation_error",
            "translation_dir_error"]


class PoseEvaluator:
    """The reference's PoseEvaluator API."""

    def __init__(self, ground_truth_loader, euler_convention: str = "yup"):
        self.gt_loader = ground_truth_loader
        self.euler_convention = euler_convention

    def evaluate_sequence(self, estimated_results):
        frames = list(estimated_results["frames"])
        est_roll = np.asarray(estimated_results["roll"], dtype=np.float64)
        est_pitch = np.asarray(estimated_results["pitch"], dtype=np.float64)
        est_yaw = np.asarray(estimated_results["yaw"], dtype=np.float64)
        est_R = np.stack([np.asarray(R) for R in estimated_results["R"]])
        est_t = np.stack([np.asarray(t).reshape(3) for t in estimated_results["t"]])

        gt_pos, gt_rpy = self.gt_loader.poses_for_frames(frames)
        gt_roll, gt_pitch, gt_yaw = gt_rpy[:, 0], gt_rpy[:, 1], gt_rpy[:, 2]

        def _wrap(e):
            return np.abs(((np.asarray(e, np.float64) + 180.0) % 360.0)
                          - 180.0)

        roll_err = _wrap(np.abs(est_roll - gt_roll))
        pitch_err = _wrap(np.abs(est_pitch - gt_pitch))
        yaw_err = _wrap(np.abs(est_yaw - gt_yaw))

        R_gt = euler_to_rotation_np(
            gt_yaw, gt_pitch, gt_roll, convention=self.euler_convention)
        rot_err = rotation_error_np(est_R, R_gt)

        # Translation direction error vs GT delta between *evaluated* frames;
        # first evaluated frame -> 0.0.
        trans_err = np.zeros(len(frames), dtype=np.float64)
        if len(frames) > 1:
            gt_delta = gt_pos[1:] - gt_pos[:-1]
            trans_err[1:] = translation_direction_error_np(
                est_t[1:], gt_delta)

        return {
            "frames": frames,
            "roll_error": roll_err,
            "pitch_error": pitch_err,
            "yaw_error": yaw_err,
            "rotation_error": rot_err,
            "translation_dir_error": trans_err,
            "gt_roll": gt_roll,
            "gt_pitch": gt_pitch,
            "gt_yaw": gt_yaw,
            "est_roll": est_roll,
            "est_pitch": est_pitch,
            "est_yaw": est_yaw,
        }

    def compute_summary_statistics(self, evaluation_results):
        """mean/std/median/max/min for the 5 metric families."""
        stats = {}
        for metric in _METRICS:
            errors = np.asarray(evaluation_results[metric])
            stats[f"{metric}_mean"] = float(np.mean(errors))
            stats[f"{metric}_std"] = float(np.std(errors))
            stats[f"{metric}_median"] = float(np.median(errors))
            stats[f"{metric}_max"] = float(np.max(errors))
            stats[f"{metric}_min"] = float(np.min(errors))
        return stats

    def create_comparison_dataframe(self, evaluation_results):
        """12-column comparison frame (a pandas DataFrame; pandas is
        imported here only, and its absence raises ImportError)."""
        try:
            import pandas as pd
        except ImportError as e:
            raise ImportError("create_comparison_dataframe needs pandas, "
                              "which is not installed; the other "
                              "PoseEvaluator methods do not") from e
        return pd.DataFrame({
            "frame": evaluation_results["frames"],
            **{k: evaluation_results[k] for k in (
                "gt_roll", "gt_pitch", "gt_yaw", "est_roll", "est_pitch",
                "est_yaw", "roll_error", "pitch_error", "yaw_error",
                "rotation_error", "translation_dir_error")},
        })

    @staticmethod
    def _wrap_angle_error(error_deg):
        return float(np.abs(((np.float64(error_deg) + 180.0) % 360.0)
                            - 180.0))

    def print_summary(self, evaluation_results):
        """The reference's console summary block."""
        stats = self.compute_summary_statistics(evaluation_results)
        print("\n" + "=" * 60)
        print("POSE ESTIMATION EVALUATION SUMMARY")
        print("=" * 60)
        print(f"\nNumber of frames evaluated: {len(evaluation_results['frames'])}")
        print("\nRotation Errors (degrees):")
        print(f"  Mean:   {stats['rotation_error_mean']:.2f}")
        print(f"  Std:    {stats['rotation_error_std']:.2f}")
        print(f"  Median: {stats['rotation_error_median']:.2f}")
        print(f"  Max:    {stats['rotation_error_max']:.2f}")
        print(f"  Min:    {stats['rotation_error_min']:.2f}")
        print("\nRoll Errors (degrees):")
        print(f"  Mean:   {stats['roll_error_mean']:.2f}")
        print(f"  Std:    {stats['roll_error_std']:.2f}")
        print("\nPitch Errors (degrees):")
        print(f"  Mean:   {stats['pitch_error_mean']:.2f}")
        print(f"  Std:    {stats['pitch_error_std']:.2f}")
        print("\nYaw Errors (degrees):")
        print(f"  Mean:   {stats['yaw_error_mean']:.2f}")
        print(f"  Std:    {stats['yaw_error_std']:.2f}")
        print("\nTranslation Direction Errors (degrees):")
        print(f"  Mean:   {stats['translation_dir_error_mean']:.2f}")
        print(f"  Std:    {stats['translation_dir_error_std']:.2f}")
        print("\n" + "=" * 60 + "\n")
