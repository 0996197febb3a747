"""KITTI odometry sequence runner: pair poses -> trajectory -> ATE/RPE
(port of rpe_tpu/cli/run_kitti_sequence.py).

Reads the frames (PNGs or baseline JPEGs, decoded natively), estimates every
consecutive pair in chunks through pipeline/batch.py, chains the relative
poses into a trajectory (monocular scale from the GT step lengths, the
standard mono-VO protocol) and reports ATE (sim3/se3-aligned) and RPE. Same
flags, outputs (`est_poses_kitti.txt`, `trajectory_summary.json`) and
printed summary as the reference. It runs on the CUDA card; `main(argv,
device="cpu")` runs the plain PyTorch versions instead (the tests do).

This runner has no --extract-cap flag, so the reference's override of the
extraction cap without its band (a cap meant per 8-row band applied per
32-row band) has nothing to reach here.

Usage:
    python -m rpe_tpu_torch.cli.run_kitti_sequence \
        --images-dir <sequences/00/image_0> --poses <poses/00.txt> \
        [--calib <sequences/00/calib.txt>] [--step 1] [--max-frames 200] \
        [--chunk 8] [--rpe-delta 1] [--results-dir DIR] [--checkpoint F]
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ._common import make_mesh


def load_kitti_calib(path, camera: str = "P0") -> np.ndarray:
    """KITTI odometry calib.txt -> 3x3 K for the given projection row.

    Each line: '<name>: p11 p12 ... p34' (12 floats, row-major 3x4). K is
    the left 3x3 of the projection (KITTI rectified cameras share it).
    """
    for line in Path(path).read_text().splitlines():
        if line.startswith(camera + ":"):
            vals = np.array([float(v) for v in line.split()[1:]],
                            dtype=np.float64)
            if vals.size != 12:
                raise ValueError(f"{camera} row has {vals.size} values, "
                                 "expected 12")
            return vals.reshape(3, 4)[:, :3].copy()
    raise ValueError(f"no '{camera}:' row in {path}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="KITTI Odometry Sequence Pose Estimation + ATE/RPE")
    p.add_argument("--images-dir", required=True,
                   help="Directory of sequential frames (e.g. "
                        "sequences/00/image_0)")
    p.add_argument("--poses", required=True,
                   help="KITTI ground-truth pose file (poses/00.txt)")
    p.add_argument("--calib", default=None,
                   help="KITTI calib.txt (P0 row used unless --calib-cam)")
    p.add_argument("--calib-cam", default="P0",
                   help="Projection row to read from calib.txt")
    p.add_argument("--step", type=int, default=1,
                   help="Frame step interval (default: 1)")
    p.add_argument("--max-frames", type=int, default=0,
                   help="Cap on frames after stepping (0 = all)")
    p.add_argument("--chunk", type=int, default=32,
                   help="Pairs per dispatch (static batch size)")
    p.add_argument("--devices", type=int, default=0,
                   help="Shard pairs over this many devices (0 = no mesh)")
    p.add_argument("--rpe-delta", type=int, default=1,
                   help="Frame delta for RPE (default: 1)")
    p.add_argument("--solver", default="5pt", choices=["5pt", "8pt"],
                   help="Minimal solver for RANSAC (default: 5pt)")
    p.add_argument("--nfeatures", type=int, default=4000)
    from ..config import PROFILE_NAMES

    p.add_argument("--profile", choices=PROFILE_NAMES, default="parity",
                   help="ORB work-cut profile (non-parity overrides "
                        "--nfeatures)")
    p.add_argument("--results-dir", default="evaluation-runs/kitti/results")
    p.add_argument("--checkpoint", default=None,
                   help="jsonl checkpoint path for resume")
    return p


def main(argv=None, device=None):
    """Run the runner; `device` is the estimator's (None: the CUDA card)."""
    args = build_parser().parse_args(argv)

    from ..io.image_loader import LazyFrameSource
    from ..pipeline.batch import BatchProcessor
    from ..pipeline.estimator import PoseEstimator
    from ..pipeline.trajectory import (
        accumulate_trajectory,
        ate,
        gt_scales,
        load_kitti_poses,
        rpe,
        save_kitti_poses,
    )

    images_dir = Path(args.images_dir)
    exts = ("*.png", "*.jpg", "*.jpeg")
    paths = sorted(p for ext in exts for p in images_dir.glob(ext))
    if len(paths) < 2:
        raise SystemExit(f"need >= 2 frames in {images_dir}, found "
                         f"{len(paths)}")

    gt_all = load_kitti_poses(args.poses)
    n = min(len(paths), len(gt_all))
    if len(paths) != len(gt_all):
        print(f"[WARN] {len(paths)} images vs {len(gt_all)} GT poses; "
              f"using first {n}")
    idx = list(range(0, n, args.step))
    if args.max_frames > 0:
        idx = idx[:args.max_frames]
    paths = [paths[i] for i in idx]
    gt = gt_all[idx]
    print(f"[INFO] {len(paths)} frames (step {args.step}) from {images_dir}")

    # Lazy decode: KITTI sequences are thousands of frames (seq 00 eager
    # would be ~8.5 GB of f32 host RAM); chunks decode just in time, while
    # the previous chunk runs (pipeline/batch.py).
    imgs = LazyFrameSource([str(p) for p in paths], to_gray=True,
                           cache_frames=max(2 * (args.chunk + 10), 64))
    h, w = imgs.get([0]).shape[1:3]

    if args.calib:
        K = load_kitti_calib(args.calib, args.calib_cam)
        print(f"[INFO] K from {args.calib} ({args.calib_cam}): "
              f"fx={K[0, 0]:.1f} fy={K[1, 1]:.1f}")
    else:
        from ..pipeline.calibration import CameraCalibration

        K = CameraCalibration().get_matrix(image_width=w, image_height=h)
        print("[INFO] No calib file; scaled default intrinsics")

    from ..config import profile_config

    prof_cfg = profile_config(args.profile)
    nfeat = (args.nfeatures if args.profile == "parity"
             else prof_cfg.orb.nfeatures)
    estimator = PoseEstimator(K, feature_method="ORB",
                              nfeatures=nfeat, config=prof_cfg,
                              device=device)
    import dataclasses

    estimator.config = dataclasses.replace(
        estimator.config,
        ransac=dataclasses.replace(estimator.config.ransac,
                                   solver=args.solver))
    # frames are remapped to positions 0..N-1 below, so the checkpoint
    # needs the dataset slice identity in its hash (which files, in which
    # order) — otherwise a rerun with a different --step/--max-frames/
    # --images-dir would silently resume foreign poses.
    salt = "|".join([str(images_dir.resolve()), f"step={args.step}",
                     f"profile={args.profile}", f"nfeatures={nfeat}",
                     f"cap={estimator.config.orb.extract_cap}"]
                    + [p.name for p in paths])
    proc = BatchProcessor(images_dir, estimator, None, chunk=args.chunk,
                          mesh=make_mesh(args.devices, device),
                          checkpoint_path=args.checkpoint,
                          checkpoint_salt=salt)
    frames = list(range(len(paths)))
    R_rel, t_rel, valid, num_matches = proc.estimate_relative_poses(
        frames, imgs)
    n_ok = int(valid.sum())
    print(f"[INFO] {n_ok}/{len(frames) - 1} pairs estimated successfully")

    est = accumulate_trajectory(R_rel, t_rel, scales=gt_scales(gt),
                                valid=valid, T0=gt[0])
    ate_sim3 = ate(est, gt, align="sim3")
    ate_se3 = ate(est, gt, align="se3")
    rpe_res = rpe(est, gt, delta=args.rpe_delta)

    results_dir = Path(args.results_dir)
    results_dir.mkdir(parents=True, exist_ok=True)
    save_kitti_poses(results_dir / "est_poses_kitti.txt", est)
    summary = {
        "n_frames": len(frames),
        "n_pairs_valid": n_ok,
        "ate_sim3": {k: v for k, v in ate_sim3.items()
                     if isinstance(v, float)},
        "ate_se3": {k: v for k, v in ate_se3.items()
                    if isinstance(v, float)},
        "rpe_delta": args.rpe_delta,
        "rpe_trans": rpe_res["trans"],
        "rpe_rot_deg": rpe_res["rot_deg"],
    }
    (results_dir / "trajectory_summary.json").write_text(
        json.dumps(summary, indent=2))

    print("\n" + "=" * 60)
    print("TRAJECTORY EVALUATION SUMMARY")
    print("=" * 60)
    print(f"\nATE (sim3-aligned, m):  RMSE {ate_sim3['rmse']:.4f}  "
          f"mean {ate_sim3['mean']:.4f}  max {ate_sim3['max']:.4f}")
    print(f"ATE (se3-aligned, m):   RMSE {ate_se3['rmse']:.4f}  "
          f"mean {ate_se3['mean']:.4f}  max {ate_se3['max']:.4f}")
    print(f"RPE delta={args.rpe_delta} trans (m):   "
          f"RMSE {rpe_res['trans']['rmse']:.4f}  "
          f"median {rpe_res['trans']['median']:.4f}")
    print(f"RPE delta={args.rpe_delta} rot (deg):   "
          f"RMSE {rpe_res['rot_deg']['rmse']:.4f}  "
          f"median {rpe_res['rot_deg']['median']:.4f}")
    print("\n" + "=" * 60 + "\n")
    print(f"[INFO] Results saved to {results_dir}/")
    return summary


if __name__ == "__main__":
    main()
