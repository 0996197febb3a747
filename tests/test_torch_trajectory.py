"""rpe_tpu_torch.pipeline.trajectory against rpe_tpu.pipeline.trajectory:
trajectory accumulation with invalid pairs, Umeyama alignment, ATE
(sim3, se3, none), RPE at deltas 1 and 2, and KITTI pose I/O. Both are
float64 numpy, so every result is held exactly."""

import numpy as np
import pytest

from rpe_tpu.pipeline import trajectory as jt
from rpe_tpu_torch.pipeline import trajectory as tt
from rpe_tpu_torch.utils.synthetic import kitti_poses, rotation_from_axis_angle


@pytest.fixture(scope="module")
def chain():
    g = np.random.default_rng(11)
    n = 12
    R = np.stack([rotation_from_axis_angle(g.normal(size=3) * 0.05)
                  for _ in range(n)])
    t = g.normal(size=(n, 3)) + np.array([0.0, 0.0, 3.0])
    t /= np.linalg.norm(t, axis=-1, keepdims=True)
    valid = g.uniform(size=n) > 0.25
    valid[0] = True
    gt = kitti_poses(rotation_from_axis_angle([0.0, 0.02, 0.0]),
                     [0.05, 0.0, 1.0], n + 1)
    gt[:, :3, 3] += 0.01 * g.normal(size=(n + 1, 3))
    return R, t, valid, gt


def _eq(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _eq(a[k], b[k])
    elif isinstance(a, tuple):
        for x, y in zip(a, b, strict=True):
            _eq(x, y)
    else:
        np.testing.assert_array_equal(a, b)


def test_accumulate_trajectory_with_invalid_pairs(chain):
    R, t, valid, gt = chain
    assert not valid.all()
    scales = jt.gt_scales(gt)
    np.testing.assert_array_equal(tt.gt_scales(gt), scales)
    for kw in ({}, {"scales": scales, "valid": valid, "T0": gt[0]},
               {"valid": valid}):
        _eq(tt.accumulate_trajectory(R, t, **kw),
            jt.accumulate_trajectory(R, t, **kw))
    _eq(tt.accumulate_trajectory(R, t[..., None], scales=scales),
        jt.accumulate_trajectory(R, t[..., None], scales=scales))


@pytest.mark.parametrize("with_scale", [True, False])
def test_umeyama(chain, with_scale):
    g = np.random.default_rng(3)
    src = g.normal(size=(20, 3))
    dst = 1.7 * src @ rotation_from_axis_angle([0.3, -0.2, 0.5]).T + 0.4
    _eq(tt.umeyama(src, dst, with_scale), jt.umeyama(src, dst, with_scale))
    with pytest.raises(ValueError):
        tt.umeyama(src, dst[:-1])


@pytest.mark.parametrize("align", ["sim3", "se3", "none"])
def test_ate(chain, align):
    R, t, valid, gt = chain
    est = jt.accumulate_trajectory(R, t, scales=jt.gt_scales(gt),
                                   valid=valid, T0=gt[0])
    _eq(tt.ate(est, gt, align=align), jt.ate(est, gt, align=align))
    _eq(tt.ate(est[:, :3, 3], gt[:, :3], align=align),
        jt.ate(est[:, :3, 3], gt[:, :3], align=align))


def test_ate_refuses_bad_input(chain):
    _, _, _, gt = chain
    with pytest.raises(ValueError, match="unknown align"):
        tt.ate(gt, gt, align="affine")
    with pytest.raises(ValueError, match="length mismatch"):
        tt.ate(gt[:-1], gt)


@pytest.mark.parametrize("delta", [1, 2])
def test_rpe(chain, delta):
    R, t, valid, gt = chain
    est = jt.accumulate_trajectory(R, t, scales=jt.gt_scales(gt),
                                   valid=valid, T0=gt[0])
    _eq(tt.rpe(est, gt, delta=delta), jt.rpe(est, gt, delta=delta))
    with pytest.raises(ValueError, match="delta"):
        tt.rpe(est, gt, delta=len(gt))


def test_kitti_pose_io_round_trip(chain, tmp_path):
    _, _, _, gt = chain
    tt.save_kitti_poses(tmp_path / "port.txt", gt)
    jt.save_kitti_poses(tmp_path / "ref.txt", gt)
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "ref.txt").read_bytes()
    back = tt.load_kitti_poses(tmp_path / "port.txt")
    np.testing.assert_array_equal(back, jt.load_kitti_poses(
        tmp_path / "port.txt"))
    np.testing.assert_allclose(back, gt, rtol=0, atol=1e-8)
    tt.save_kitti_poses(tmp_path / "34.txt", gt[:, :3, :])
    np.testing.assert_array_equal(tt.load_kitti_poses(tmp_path / "34.txt"),
                                  back)
    (tmp_path / "bad.txt").write_text("1 2 3\n")
    with pytest.raises(ValueError, match="12 columns"):
        tt.load_kitti_poses(tmp_path / "bad.txt")
