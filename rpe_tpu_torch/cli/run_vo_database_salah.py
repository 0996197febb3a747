"""Salah VO dataset pipeline runner (port of
rpe_tpu/cli/run_vo_database_salah.py).

Runs on the CUDA card; `main(argv, device="cpu")` runs the plain PyTorch
versions instead.

Usage:
    python -m rpe_tpu_torch.cli.run_vo_database_salah [--step STEP] [--no-plot]
        [--no-video] [--video-fps FPS]
"""

from __future__ import annotations

from pathlib import Path

from ._common import make_mesh, sequence_parser


def main(argv=None, device=None):
    args = sequence_parser("Salah Qadah Dataset Pose Estimation Pipeline",
                           default_step=5, default_fps=5).parse_args(argv)

    from ..pipeline.calibration import load_K_npz
    from ..pipeline.orchestrator import PoseEstimationPipeline

    data_dir = Path(args.data_root) / "evaluation-runs/vo_dataset_salah/data"
    results_dir = args.results_dir or "evaluation-runs/vo_dataset_salah/results"
    K = load_K_npz(data_dir / "calibration.npz")
    pipeline = PoseEstimationPipeline(
        data_dir=data_dir,
        gt_filename="camera_poses_zyx.txt",
        camera_matrix=K,
        results_dir=results_dir,
        feature_method=args.feature,
        norm_type="Hamming" if args.feature == "ORB" else "L2",
        max_matches=500,
        euler_convention="zyx",  # dataset uses ZYX convention
        mesh=make_mesh(args.devices, device),
        chunk=args.chunk,
        profile=args.profile,
        seed=args.seed,
        extract_cap=args.extract_cap,
        device=device,
    )
    pipeline.setup()
    results = pipeline.run(
        step=args.step,
        create_plot=not args.no_plot,
        create_video=not args.no_video,
        video_fps=args.video_fps,
    )
    print(f"\n[INFO] Pipeline completed. Results saved to {results_dir}/")
    return results


if __name__ == "__main__":
    main()
