"""Single image-pair pose estimation (port of rpe_tpu/cli/run_single_pair.py).

VP refinement is on, as in the reference, but with no previous rotation it
does not run, so the plain pose comes back. Runs on the CUDA card;
`main(argv, device="cpu")` runs the plain PyTorch versions instead.

Usage:
    python -m rpe_tpu_torch.cli.run_single_pair [--img1 PATH] [--img2 PATH]
        [--calibration CALIB_FILE]
"""

from __future__ import annotations

import argparse

import numpy as np

from ._common import default_data_root


def main(argv=None, device=None):
    root = default_data_root()
    parser = argparse.ArgumentParser(description="Single Pair Pose Estimation")
    parser.add_argument(
        "--img1", default=f"{root}/evaluation-runs/single-pair/images/000000.png",
        help="Path to first image")
    parser.add_argument(
        "--img2", default=f"{root}/evaluation-runs/single-pair/images/000015.png",
        help="Path to second image")
    parser.add_argument(
        "--calibration", "-c",
        help='Optional path to calibration .npz file (must contain "K" matrix)')
    args = parser.parse_args(argv)

    from ..io.image_loader import load_image
    from ..pipeline.calibration import CameraCalibration
    from ..pipeline.estimator import PoseEstimator

    img1 = load_image(args.img1, to_gray=True)
    img2 = load_image(args.img2, to_gray=True)

    if args.calibration:
        K = np.load(args.calibration)["K"]
    else:
        K = CameraCalibration().get_matrix(img1.shape[1], img1.shape[0])

    estimator = PoseEstimator(
        camera_matrix=K,
        feature_method="ORB",
        nfeatures=4000,
        use_vp_refinement=True,
        device=device,
    )
    R, t = estimator.estimate(img1, img2)

    print("\n=== Relative Pose Estimation ===")
    print(f"\nImages: {args.img1} -> {args.img2}")
    print("\nRotation Matrix R:")
    print(R)
    print("\nTranslation t (direction only):")
    print(t.flatten())
    return R, t


if __name__ == "__main__":
    main()
