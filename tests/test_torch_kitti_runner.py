"""rpe_tpu_torch.cli.run_kitti_sequence against rpe_tpu.cli.run_kitti_sequence
on the CPU: the calibration reader, and both packages' `main` on one
written sequence (5 frames of 188x620, the parity profile at 512 features,
chunk 2) into separate results directories.

Contracts:
- The runner's own half (frame listing, K, GT scales, accumulation,
  ATE/RPE, outputs), both packages handed the reference's per-pair poses:
  `n_pairs_valid` equal, every ATE and RPE statistic within 1e-4 relative.
- End to end: `n_pairs_valid` equal; each relative rotation of the written
  trajectory within 0.5 deg of the reference's, the per-pair bound
  tests/test_torch_pipeline.py holds (a BRIEF bit that float32 steering
  rounds the other way -- the kernel contract allows 1 in 1000 -- can move
  a cross-check match and so a pose by tenths of a degree; ROADMAP.md,
  Known divergences); and the se3 ATE within the RMS distance between the
  two estimated trajectories, which bounds how far it can move."""

import json

import numpy as np
import pytest

from rpe_tpu.cli import run_kitti_sequence as jrun
from rpe_tpu.pipeline import batch as jbatch
from rpe_tpu_torch.cli import run_kitti_sequence as trun
from rpe_tpu_torch.pipeline import batch as tbatch
from rpe_tpu_torch.pipeline.trajectory import load_kitti_poses
from rpe_tpu_torch.utils.synthetic import make_sequence, rotation_error_deg, \
    write_kitti_sequence
from torch_gates import default_extraction_gates  # noqa: F401
from torch_gates import one_torch_thread  # noqa: F401


def test_load_kitti_calib_equals_reference(tmp_path):
    calib = tmp_path / "calib.txt"
    calib.write_text(
        "P0: 718.856 0.0 607.1928 0.0 0.0 718.856 185.2157 0.0 0.0 0.0 1.0 "
        "0.0\nP1: " + " ".join(["1.5"] * 12) + "\nP2: 1 2 3\n")
    for cam in ("P0", "P1"):
        np.testing.assert_array_equal(trun.load_kitti_calib(calib, cam),
                                      jrun.load_kitti_calib(calib, cam))
    with pytest.raises(ValueError, match="no 'P9:' row"):
        trun.load_kitti_calib(calib, "P9")
    with pytest.raises(ValueError, match="expected 12"):
        trun.load_kitti_calib(calib, "P2")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("kitti")
    frames, K, (R, t) = make_sequence(5, 188, 620, seed=6)
    images, poses, calib = write_kitti_sequence(root, frames, K, R, t)
    args = ["--images-dir", str(images), "--poses", str(poses), "--calib",
            str(calib), "--chunk", "2", "--nfeatures", "512"]
    pairs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RPE_PLATFORM", "cpu")
        orig = jbatch.BatchProcessor.estimate_relative_poses

        def keep(self, frames, imgs):
            pairs["ref"] = orig(self, frames, imgs)
            return pairs["ref"]

        mp.setattr(jbatch.BatchProcessor, "estimate_relative_poses", keep)
        ref = jrun.main(args + ["--results-dir", str(root / "ref")])
    got = trun.main(args + ["--results-dir", str(root / "port"),
                            "--checkpoint", str(root / "port.jsonl")],
                    device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tbatch.BatchProcessor, "estimate_relative_poses",
                   lambda self, frames, imgs: pairs["ref"])
        same = trun.main(args + ["--results-dir", str(root / "same")],
                         device="cpu")
    return root, ref, got, same


def _rel_rotations(path):
    T = load_kitti_poses(path)
    return np.einsum("nji,njk->nik", T[:-1, :3, :3], T[1:, :3, :3])


def test_runner_half_matches_reference_on_the_same_pairs(runs):
    _, ref, _, same = runs
    assert same.keys() == ref.keys()
    assert same["n_frames"] == ref["n_frames"] == 5
    assert same["n_pairs_valid"] == ref["n_pairs_valid"] == 4
    assert same["rpe_delta"] == ref["rpe_delta"]
    for block in ("ate_sim3", "ate_se3", "rpe_trans", "rpe_rot_deg"):
        assert same[block].keys() == ref[block].keys()
        for k in same[block]:
            assert same[block][k] == pytest.approx(ref[block][k], rel=1e-4), \
                (block, k)


def test_runner_end_to_end_matches_reference(runs):
    root, ref, got, _ = runs
    assert got.keys() == ref.keys()
    assert got["n_pairs_valid"] == ref["n_pairs_valid"] == 4
    Rp = _rel_rotations(root / "port" / "est_poses_kitti.txt")
    Rr = _rel_rotations(root / "ref" / "est_poses_kitti.txt")
    assert rotation_error_deg(Rp, Rr).max() < 0.5
    pp = load_kitti_poses(root / "port" / "est_poses_kitti.txt")[:, :3, 3]
    pr = load_kitti_poses(root / "ref" / "est_poses_kitti.txt")[:, :3, 3]
    apart = float(np.sqrt(np.mean(np.sum((pp - pr) ** 2, -1))))
    assert abs(got["ate_se3"]["rmse"] - ref["ate_se3"]["rmse"]) \
        <= apart + 1e-12
    assert got["ate_sim3"]["rmse"] < 0.5


def test_runner_outputs(runs):
    root, _, got, _ = runs
    for name in ("ref", "port"):
        est = load_kitti_poses(root / name / "est_poses_kitti.txt")
        assert est.shape == (5, 4, 4)
        saved = json.loads(
            (root / name / "trajectory_summary.json").read_text())
        assert saved.keys() == got.keys()
    assert json.loads((root / "port" / "trajectory_summary.json")
                      .read_text()) == json.loads(json.dumps(got))
    lines = (root / "port.jsonl").read_text().splitlines()
    assert len(lines) == 5 and "config_hash" in json.loads(lines[0])


def test_runner_refuses_a_mesh(runs):
    """Once a refusal, now the mesh path: `--devices 2` on the CPU (two
    CPU entries, chunk 2 split one pair a device) writes the
    trajectory_summary.json of the run without a mesh."""
    root = runs[0]
    trun.main(["--images-dir", str(root / "image_0"), "--poses",
               str(root / "poses.txt"), "--calib", str(root / "calib.txt"),
               "--chunk", "2", "--nfeatures", "512", "--devices", "2",
               "--results-dir", str(root / "mesh")], device="cpu")
    assert json.loads((root / "mesh" / "trajectory_summary.json")
                      .read_text()) == json.loads(
        (root / "port" / "trajectory_summary.json").read_text())
