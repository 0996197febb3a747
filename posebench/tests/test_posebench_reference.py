"""The generator against its own ground truth, and the plain reference's
pose judge on exact correspondences of a generated frame pair."""

import json

import numpy as np
import torch

import scene
from helpers import BENCH, TINY
from reference import pose

TRAFFIC = dict(json.loads((BENCH / "traffic" / "kitti_b32.json")
                          .read_text()), **TINY)


def _correspondences(seed=5, n=400):
    frames, (R, t_unit) = scene.make_chunk(TRAFFIC, 2, seed, "cpu")
    _, t = scene.motion(TRAFFIC, scene.mix_seed(seed, 1))
    K = scene.camera(TRAFFIC)
    h, w = TRAFFIC["height"], TRAFFIC["width"]
    depth = TRAFFIC["depths"][0]            # the top strip's plane
    top = int(round(h / len(TRAFFIC["depths"])))
    rng = np.random.default_rng(seed)
    u = rng.uniform(40, w - 40, n)
    v = rng.uniform(5, top - 5, n)
    X = depth * (np.linalg.inv(K) @ np.stack([u, v, np.ones(n)]))
    x2 = K @ (R @ X + t[:, None])
    u2, v2 = x2[0] / x2[2], x2[1] / x2[2]
    return frames, K, R, t_unit, np.stack([u, v], 1), np.stack([u2, v2], 1)


def test_frames_follow_the_motion():
    frames, K, R, t, p1, p2 = _correspondences()
    assert frames.shape == (2, TRAFFIC["height"], TRAFFIC["width"])
    assert frames.dtype == torch.float32
    inside = ((p2[:, 0] >= 0) & (p2[:, 0] < TRAFFIC["width"] - 1)
              & (p2[:, 1] >= 0) & (p2[:, 1] < TRAFFIC["height"] - 1))
    a = frames[0][torch.as_tensor(p1[inside, 1]).long(),
                  torch.as_tensor(p1[inside, 0]).long()]
    # the texture is constant over 8 px cells: most points keep their value
    b = frames[1][torch.as_tensor(np.floor(p2[inside, 1])).long(),
                  torch.as_tensor(np.floor(p2[inside, 0])).long()]
    assert float((a == b).float().mean()) > 0.7


def test_same_seed_same_frames():
    a, _ = scene.make_chunk(TRAFFIC, 2, 7, "cpu")
    b, _ = scene.make_chunk(TRAFFIC, 2, 7, "cpu")
    c, _ = scene.make_chunk(TRAFFIC, 2, 8, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert np.array_equal(scene.make_keys(2 ** 31 + 9, 4),
                          scene.make_keys(2 ** 31 + 9, 4))


def _pair(R, t, p1, p2):
    n = p1.shape[0]
    return {"pts1": torch.as_tensor(p1, dtype=torch.float32),
            "pts2": torch.as_tensor(p2, dtype=torch.float32),
            "match_valid": torch.ones(n, dtype=torch.bool),
            "inlier_mask": torch.ones(n, dtype=torch.bool),
            "num_matches": torch.tensor(n), "num_inliers": torch.tensor(n),
            "valid": torch.tensor(True),
            "R": torch.as_tensor(R, dtype=torch.float32),
            "t": torch.as_tensor(t, dtype=torch.float32)}


def test_judge_accepts_the_ground_truth():
    _, K, R, t, p1, p2 = _correspondences()
    r = pose.judge_pair(_pair(R, t, p1, p2), torch.as_tensor(K), 1.0)
    assert r["pose_off"] == 0 and r["inlier_gap"] == 0.0
    assert r["rot_gap"] < 1e-6


def test_judge_rejects_a_wrong_pose():
    _, K, R, t, p1, p2 = _correspondences()
    Kt = torch.as_tensor(K)
    turned = scene.rotation_from_axis_angle([0.0, np.deg2rad(0.5), 0.0]) @ R
    assert pose.judge_pair(_pair(turned, t, p1, p2), Kt, 1.0)[
        "inlier_gap"] > 1.0
    # the mirrored translation explains the same epipolar lines but puts
    # the points behind the cameras: recoverPose's choice is wrong
    assert pose.judge_pair(_pair(R, -t, p1, p2), Kt, 1.0)["pose_off"] == 1
    bad = _pair(R, t, p1, p2)
    bad["num_inliers"] = torch.tensor(3)
    assert pose.judge_pair(bad, Kt, 1.0)["pose_off"] >= 1


def test_scan_reads_every_pair():
    """posebench/scan.py over a tiny pool: one row per pair of every
    chunk, the program's inliers near the truth's on a sound run."""
    import scan

    config = json.loads((BENCH / "configs" / "orb4000.json").read_text())
    rows = scan.scan_seed(config, TRAFFIC, 2 ** 31 + 21, "cpu")
    assert len(rows) == TRAFFIC["pool"] * TRAFFIC["pairs"]
    assert all(nt > 0 and s <= 0.05 for _, _, nt, _, s, _ in rows), rows
