"""High-level pipeline orchestration (port of
rpe_tpu/pipeline/orchestrator.py).

Same wiring order, knobs, console output, artifacts and returned dict as the
reference's `PoseEstimationPipeline`; underneath runs the port's batched
path (pipeline/batch.py) on the CUDA card, or on the device the caller
names with `device=`. `evaluation_results.csv` is written with the `csv`
module, byte for byte what pandas' `to_csv(index=False)` writes for the same
table, so the card machine needs no pandas.
"""

from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

from ..geometry.rotations import CONVENTION_YUP, rotation_to_euler_yup
from ..io.image_loader import load_image, load_image_pair
from .batch import BatchProcessor
from .calibration import CameraCalibration
from .estimator import PoseEstimator
from .evaluator import PoseEvaluator
from .ground_truth import GroundTruthLoader

COMPARISON_COLUMNS = (
    "frame", "gt_roll", "gt_pitch", "gt_yaw", "est_roll", "est_pitch",
    "est_yaw", "roll_error", "pitch_error", "yaw_error", "rotation_error",
    "translation_dir_error")


def comparison_table(evaluation_results):
    """The 12-column comparison table as {column: numpy array}."""
    src = dict(evaluation_results, frame=evaluation_results["frames"])
    return {k: np.asarray(src[k]) for k in COMPARISON_COLUMNS}


def _csv_cell(v):
    """A cell as pandas writes it: floats by repr (shortest round trip),
    NaN empty, integers and booleans by str."""
    if isinstance(v, (float, np.floating)):
        return "" if np.isnan(v) else repr(float(v))
    if isinstance(v, np.integer):
        return str(int(v))
    return str(v)


def write_comparison_csv(path, table) -> None:
    """Write `table` ({column: array}) as pandas' `to_csv(index=False)`
    does: a header row, then one row per entry, "\\n" line ends."""
    cols = list(table)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(cols)
        for row in zip(*(table[c] for c in cols)):
            w.writerow([_csv_cell(v) for v in row])


class PoseEstimationPipeline:
    """The reference's PoseEstimationPipeline API, plus `device` (None =
    the CUDA card, or e.g. "cpu" for the plain PyTorch versions)."""

    def __init__(
        self,
        data_dir="data",
        images_dir=None,
        results_dir="results",
        gt_filename="camera_poses.txt",
        camera_matrix=None,
        calibration_file=None,
        feature_method="ORB",
        norm_type="Hamming",
        max_matches=500,
        euler_convention=CONVENTION_YUP,
        use_vp_refinement=True,
        nfeatures=4000,
        mesh=None,
        chunk=8,
        profile="parity",
        seed=0,
        extract_cap=None,
        device=None,
    ):
        self.data_dir = Path(data_dir)
        self.images_dir = Path(images_dir) if images_dir else self.data_dir / "images"
        self.gt_path = self.data_dir / gt_filename
        self.results_dir = Path(results_dir)
        self.results_dir.mkdir(parents=True, exist_ok=True)

        self.feature_method = feature_method
        self.norm_type = norm_type
        self.max_matches = max_matches
        self.camera_matrix = camera_matrix
        self.calibration_file = calibration_file
        self.euler_convention = euler_convention
        self.use_vp_refinement = use_vp_refinement
        self.mesh = mesh
        self.chunk = chunk
        self.device = device
        # ORB work-cut profile (config.profile_config): a non-parity
        # profile owns nfeatures/nlevels/max_kpts; the explicit nfeatures
        # kwarg applies only at parity.
        from ..config import profile_config

        self.profile = profile
        self.estimator_config = profile_config(profile)
        self.nfeatures = (nfeatures if profile == "parity"
                          else self.estimator_config.orb.nfeatures)
        if extract_cap is not None:
            # Extraction slots per band of the profile's band height
            # (OrbConfig.extract_cap); the band stays the profile's, as in
            # the reference.
            import dataclasses

            self.estimator_config = dataclasses.replace(
                self.estimator_config,
                orb=dataclasses.replace(self.estimator_config.orb,
                                        extract_cap=int(extract_cap)))
        # RANSAC base seed (per-pair key = seed + pair index,
        # pipeline/batch.py). Sweeps should space seeds wider than the
        # largest frame index so per-pair key sets cannot overlap.
        self.seed = seed

        self.camera_calibration = None
        self.gt_loader = None
        self.pose_estimator = None
        self.batch_processor = None
        self.pose_evaluator = None
        self.visualizer = None

    def setup(self):
        """Initialize components in the reference's order."""
        self.gt_loader = GroundTruthLoader(self.gt_path)
        self.gt_loader.load()

        self.camera_calibration = CameraCalibration(
            camera_matrix=self.camera_matrix,
            calibration_file=self.calibration_file,
        )
        sample_frames = self.gt_loader.get_all_frames()
        sample_img_path = self.images_dir / f"{sample_frames[0]:06d}.png"
        sample_img = load_image(str(sample_img_path), to_gray=True)
        K = self.camera_calibration.get_matrix_from_image(sample_img)

        self.pose_estimator = PoseEstimator(
            camera_matrix=K,
            feature_method=self.feature_method,
            norm_type=self.norm_type,
            max_matches=self.max_matches,
            nfeatures=self.nfeatures,
            use_vp_refinement=self.use_vp_refinement,
            config=self.estimator_config,
            device=self.device,
        )
        self.batch_processor = BatchProcessor(
            images_dir=self.images_dir,
            pose_estimator=self.pose_estimator,
            ground_truth_loader=self.gt_loader,
            euler_convention=self.euler_convention,
            mesh=self.mesh,
            chunk=self.chunk,
            seed=self.seed,
        )
        self.pose_evaluator = PoseEvaluator(
            ground_truth_loader=self.gt_loader,
            euler_convention=self.euler_convention,
        )
        from ..viz.visualizer import Visualizer

        self.visualizer = Visualizer(output_dir=self.results_dir)

        print("[INFO] Pipeline initialized")
        print(f"[INFO] Data directory: {self.data_dir}")
        print(f"[INFO] Images directory: {self.images_dir}")
        print(f"[INFO] Ground truth: {self.gt_path}")
        print(f"[INFO] Results directory: {self.results_dir}")
        print(f"[INFO] Feature method: {self.feature_method} "
              f"(nfeatures={self.nfeatures})")
        print(f"[INFO] Euler convention: {self.euler_convention}")
        print(f"[INFO] VP refinement: "
              f"{'Enabled' if self.use_vp_refinement else 'Disabled'}")
        print(f"[INFO] Camera matrix K computed from image size: "
              f"{sample_img.shape}")

    def run(self, step=15, create_plot=True, create_video=False, video_fps=10):
        """Full pipeline run. Returns {"estimated", "evaluation",
        "comparison_df"}: the last is a pandas DataFrame where pandas
        imports, else the same 12 columns as a dict of numpy arrays
        (`comparison_table`)."""
        if self.batch_processor is None:
            raise RuntimeError("Pipeline not initialized. Call setup() first.")

        print(f"\n[INFO] Running pipeline with step={step}")
        print("[INFO] Processing image sequence...")
        estimated_results = self.batch_processor.process_at_interval(step=step)
        print(f"[INFO] Processed {len(estimated_results['frames'])} frame pairs")

        print("[INFO] Evaluating against ground truth...")
        evaluation_results = self.pose_evaluator.evaluate_sequence(
            estimated_results)
        self.pose_evaluator.print_summary(evaluation_results)

        table = comparison_table(evaluation_results)
        csv_path = self.results_dir / "evaluation_results.csv"
        write_comparison_csv(csv_path, table)
        print(f"[INFO] Evaluation results saved to: {csv_path}")
        try:
            import pandas as pd
        except ImportError:
            comparison_df = table
        else:
            comparison_df = pd.DataFrame(table)

        if create_plot:
            print("[INFO] Creating 3D trajectory plot...")
            self.visualizer.plot_3d_trajectory(
                gt_trajectory_full=self.gt_loader.get_trajectory(step=1),
                gt_trajectory_filtered=self.gt_loader.get_trajectory(step=step),
                gt_orientations_filtered=self.gt_loader.get_orientations(step=step),
                evaluation_results=evaluation_results,
                step=step,
            )
        if create_video:
            print("[INFO] Creating annotated video...")
            self.visualizer.create_video(
                images_dir=self.images_dir,
                evaluation_results=evaluation_results,
                output_filename="pose_comparison.mp4",
                fps=video_fps,
            )

        print("\n[INFO] Pipeline complete!")
        return {
            "estimated": estimated_results,
            "evaluation": evaluation_results,
            "comparison_df": comparison_df,
        }

    def run_single_pair(self, frame1_idx, frame2_idx, show_debug=False):
        """Single-pair estimate + GT printout."""
        if self.pose_estimator is None:
            raise RuntimeError("Pipeline not initialized. Call setup() first.")

        print(f"\n[INFO] Processing single pair: frames {frame1_idx} -> "
              f"{frame2_idx}")
        img1_path = self.images_dir / f"{frame1_idx:06d}.png"
        img2_path = self.images_dir / f"{frame2_idx:06d}.png"
        img1, img2 = load_image_pair(str(img1_path), str(img2_path), to_gray=True)

        if show_debug:
            result = self.pose_estimator.estimate_with_debug(img1, img2)
            R, t = result["R"], result["t"]
            print(f"[DEBUG] Number of matches: {result['num_matches']}")
            print(f"[DEBUG] Inliers: {result['inliers']}")
        else:
            R, t = self.pose_estimator.estimate(img1, img2)

        # Always yup here, as the reference does whatever the convention.
        yaw, pitch, roll = (float(v) for v in rotation_to_euler_yup(R))
        print("[INFO] Estimated relative pose:")
        print(f"  Yaw:   {yaw:.2f}°")
        print(f"  Pitch: {pitch:.2f}°")
        print(f"  Roll:  {roll:.2f}°")

        gt_pose1 = self.gt_loader.get_pose(frame1_idx)
        gt_pose2 = self.gt_loader.get_pose(frame2_idx)
        print("\n[INFO] Ground truth poses:")
        print(f"  Frame {frame1_idx}: yaw={gt_pose1['yaw']:.2f}°, "
              f"pitch={gt_pose1['pitch']:.2f}°, roll={gt_pose1['roll']:.2f}°")
        print(f"  Frame {frame2_idx}: yaw={gt_pose2['yaw']:.2f}°, "
              f"pitch={gt_pose2['pitch']:.2f}°, roll={gt_pose2['roll']:.2f}°")

        return {
            "R": np.asarray(R),
            "t": np.asarray(t),
            "yaw": yaw,
            "pitch": pitch,
            "roll": roll,
            "gt_pose1": gt_pose1,
            "gt_pose2": gt_pose2,
        }
