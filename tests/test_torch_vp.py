"""rpe_tpu_torch.geometry.vp_refine and its hooks against rpe_tpu on the CPU,
on Manhattan rooms made from seeds (utils/synthetic.py
`manhattan_sequence`, at most 160x240, 8-bit).

Contracts:
- Host twin (`_dirs_from_lines`, float64 numpy, the reference's code):
  identical output on identical segments, in the exhaustive regime and in
  the sampled one (numpy's generator seeded per frame), with a float32 K
  (PoseEstimator's) and a float64 K (process_sequence's).
- Tensor twin (`_dirs_from_lines_device`) against the reference's device
  twin, per key, both regimes: equal `ok`, `acc_max` and `vp2_score` at
  rtol 2e-4 (tests/test_vp_device.py:129-133), the same directions within
  0.1 deg. The sampled draws are bit-equal (rng.randint), so this holds
  per key, not only in distribution.
- LM: `optimize_rotation_from_vps` with jacobian_sign +1 and -1 to 1e-12;
  its tensor twin to 1e-5 against the reference's jitted one.
- `refine_rotation_with_vps` and its device twin, passing and gated (the
  reference's own cases, tests/test_vp_refine.py:130-162,
  test_vp_device.py:140-170, 209-219): equal `used`, R within 1e-6 (host)
  and 1e-4 (device); gated R_rel passes through unchanged.
- `PoseEstimator.estimate_with_debug(..., R_prev)`: the same VP statistics
  and `vp_used`; R within 1e-3 deg of the reference's when VP is used (the
  LM's optimum does not depend on the start), else within the 0.5 deg the
  plain pose is held to (tests/test_torch_pipeline.py).
- `BatchProcessor.process_sequence` with VP on, both packages handed the
  same relative poses, over 10 frames (a full block of 8 and a padded one,
  frames seeded by their position in the block): the host twin's outputs
  within 1e-6, the tensor twin's (RPE_VP_DEVICE=1) within 1e-4 deg, and
  the same pairs refined.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpe_tpu.config import VpConfig as JVp
from rpe_tpu.geometry import vp_refine as jvp
from rpe_tpu.ops import lsd as jlsd
from rpe_tpu_torch.config import VpConfig as TVp
from rpe_tpu_torch.geometry import vp_refine as tvp
from rpe_tpu_torch.utils.synthetic import manhattan_sequence, \
    rotation_error_deg
from torch_gates import default_extraction_gates  # noqa: F401
from torch_gates import one_torch_thread  # noqa: F401


def _u8(f):
    return np.clip(np.rint(f), 0, 255).astype(np.float32)


@pytest.fixture(scope="module")
def room():
    frames, K, S, yaw, C = manhattan_sequence(10, 160, 240, seed=3,
                                              rot_deg=1.0)
    return _u8(frames), K, S, yaw, C


@pytest.fixture(scope="module")
def segments(room):
    """The reference's segments of frame 0: host (N, 4) float64 and device
    (256, 4) float32 with their valid mask."""
    g = room[0][0]
    host = jlsd.detect_line_segments(g)
    segs, valid = jlsd.detect_line_segments_device(jnp.asarray(g))
    return host, np.asarray(segs), np.asarray(valid)


# exhaustive (max_pairs above the frame's pair count) and sampled (below
# it) regimes
REGIMES = {"exhaustive": {"max_pairs": 30000}, "sampled": {"max_pairs": 2000}}


@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("kdtype", [np.float32, np.float64])
def test_host_dirs_identical_on_equal_segments(room, segments, regime,
                                               kdtype):
    host, _, _ = segments
    m = host.shape[0]
    kw = REGIMES[regime]
    assert (m * (m - 1) // 2 > kw["max_pairs"]) == (regime == "sampled")
    K = room[1].astype(kdtype)
    for seed in (0, 5):
        D1, ok1, d1 = jvp._dirs_from_lines(host, K, JVp(enabled=True, **kw),
                                           rng_seed=seed)
        D2, ok2, d2 = tvp._dirs_from_lines(host, K, TVp(enabled=True, **kw),
                                           rng_seed=seed)
        assert ok1 and ok2 and d1 == d2
        np.testing.assert_array_equal(D2, D1)
    # a regime where the sparse vote can leave VP2's circle empty: the
    # failure is the reference's too
    for seed in range(4):
        D1, ok1, d1 = jvp._dirs_from_lines(host, K, JVp(enabled=True,
                                                        max_pairs=300),
                                           rng_seed=seed)
        D2, ok2, d2 = tvp._dirs_from_lines(host, K, TVp(enabled=True,
                                                        max_pairs=300),
                                           rng_seed=seed)
        assert ok2 == ok1 and d2 == d1
        assert (D2 is None) == (D1 is None)
        if D1 is not None:
            np.testing.assert_array_equal(D2, D1)


@pytest.mark.parametrize("regime", list(REGIMES))
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_dirs_per_key(room, segments, regime, seed):
    _, segs, valid = segments
    kw = REGIMES[regime]
    K = room[1]
    D1, ok1, s1 = jvp._dirs_from_lines_device(
        segs, valid, K, JVp(enabled=True, **kw), rng_seed=seed)
    D2, ok2, s2 = tvp._dirs_from_lines_device(
        torch.from_numpy(segs), torch.from_numpy(valid), K,
        TVp(enabled=True, **kw), rng_seed=seed)
    assert bool(ok2) == bool(ok1)
    assert bool(ok1) or regime == "sampled"
    assert int(s2["num_lines"]) == int(s1["num_lines"])
    for k in ("acc_max", "vp2_score"):
        np.testing.assert_allclose(float(s2[k]), float(s1[k]), rtol=2e-4)
    D1 = np.asarray(D1, np.float64)
    D2 = D2.numpy().astype(np.float64)
    cos = np.clip(np.abs(np.sum(D1 * D2, axis=0)), 0.0, 1.0)
    assert np.degrees(np.arccos(cos)).max() < 0.1


def _vp_problems(n, seed):
    g = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        A = np.linalg.qr(g.normal(size=(3, 3)))[0]
        R_true = jvp._so3_exp_np(g.normal(size=3) * 0.3)
        D_world = R_true.T @ A
        R_init = jvp._so3_exp_np(g.normal(size=3) * 0.05) @ R_true
        out.append((R_init, A, D_world))
    return out


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_lm_host_identical(sign):
    cfg_j, cfg_t = JVp(enabled=True), TVp(enabled=True)
    for R_init, A, Dw in _vp_problems(20, 11):
        want = jvp.optimize_rotation_from_vps(R_init, A, Dw, cfg_j,
                                              jacobian_sign=sign)
        got = tvp.optimize_rotation_from_vps(R_init, A, Dw, cfg_t,
                                             jacobian_sign=sign)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert tvp.vp_cost(got, A, Dw) == jvp.vp_cost(want, A, Dw)


def test_lm_tensor_twin_matches_reference_jit():
    lm = jax.jit(jvp.optimize_rotation_from_vps_jit)
    for R_init, A, Dw in _vp_problems(10, 12):
        args = [x.astype(np.float32) for x in (R_init, A, Dw)]
        want = np.asarray(lm(*args))
        got = tvp.optimize_rotation_from_vps_jit(
            *(torch.from_numpy(x) for x in args))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(
            float(tvp.vp_cost_jit(got, *(torch.from_numpy(x)
                                         for x in args[1:]))),
            float(jvp.vp_cost_jit(want, *args[1:])), rtol=0, atol=1e-5)


PERMISSIVE = dict(enabled=True, acc_min=0.0, vp2_min=0.0)
GATED = dict(enabled=True, acc_min=1e18, vp2_min=1e18)
R_BAD = jvp._so3_exp_np(np.array([0.03, -0.02, 0.04]))


@pytest.mark.parametrize("gates", ["passing", "gated"])
def test_refine_host_twin(room, gates):
    g = room[0][0]
    K = room[1]
    # all-pairs regime: the two roles' seeds (0, 1) see the same vote
    kw = dict(PERMISSIVE if gates == "passing" else GATED, max_pairs=30000)
    want = jvp.refine_rotation_with_vps(g, g, np.eye(3), R_BAD, K, JVp(**kw))
    got = tvp.refine_rotation_with_vps(g, g, np.eye(3), R_BAD, K, TVp(**kw),
                                       device="cpu")
    assert got[1] == want[1] == (gates == "passing")
    assert got[2]["reliability"] == want[2]["reliability"]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    if gates == "gated":
        np.testing.assert_array_equal(got[0], R_BAD)
    else:
        # same frame twice: the refinement pulls R_rel back to ~identity
        assert rotation_error_deg(got[0], np.eye(3)) < 0.1


@pytest.mark.parametrize("gates", ["passing", "gated"])
def test_refine_device_twin(room, gates):
    g = room[0][0]
    K = room[1]
    kw = PERMISSIVE if gates == "passing" else GATED
    # max_pairs above the room's pair count: the all-pairs regime, so the
    # two roles' seeds (0, 1) see the same vote
    cfg_j = JVp(max_pairs=30000, **kw)
    cfg_t = TVp(max_pairs=30000, **kw)
    R_rel = R_BAD.astype(np.float32)
    want = jax.jit(lambda a, b, Rp, Rr: jvp.refine_rotation_with_vps_device(
        a, b, Rp, Rr, K, cfg_j))(g, g, np.eye(3, dtype=np.float32), R_rel)
    got = tvp.refine_rotation_with_vps_device(
        g, g, np.eye(3, dtype=np.float32), R_rel, K, cfg_t, device="cpu")
    assert bool(got[1]) == bool(want[1]) == (gates == "passing")
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-4)
    for k in ("prev_acc_max", "new_acc_max", "prev_vp2", "new_vp2"):
        np.testing.assert_allclose(float(got[2][k]), float(want[2][k]),
                                   rtol=2e-4)
    if gates == "gated":
        np.testing.assert_array_equal(got[0].numpy(), R_rel)
    else:
        R = got[0].numpy().astype(np.float64)
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)
        assert rotation_error_deg(R, np.eye(3)) < 0.1


def test_pose_estimator_with_r_prev(room):
    from rpe_tpu.pipeline.estimator import PoseEstimator as JPE
    from rpe_tpu_torch.pipeline.estimator import PoseEstimator as TPE

    frames, K = room[0], room[1]
    kw = dict(use_vp_refinement=True, vp_acc_min=0.0, vp_vp2_min=0.0,
              nfeatures=512)
    R_prev = np.eye(3)
    want = JPE(K, **kw).estimate_with_debug(frames[0], frames[1], R_prev)
    got = TPE(K, device="cpu", **kw).estimate_with_debug(
        frames[0], frames[1], R_prev)
    assert got["vp_used"] == want["vp_used"]
    for role in ("prev_frame", "new_frame"):
        a, b = got["vp_debug"][role], want["vp_debug"][role]
        assert a["num_lines"] == b["num_lines"]
        np.testing.assert_allclose(a["acc_max"], b["acc_max"], rtol=1e-9)
        np.testing.assert_allclose(a["vp2_score"], b["vp2_score"], rtol=1e-9)
    tol = 1e-3 if want["vp_used"] else 0.5
    assert rotation_error_deg(got["R"], want["R"]) < tol


@pytest.fixture(scope="module")
def sequence(room, tmp_path_factory):
    """Both packages' process_sequence over the room's 10 frames, handed
    the same relative poses (the scene's rotation, perturbed per pair), with
    the host twin and with RPE_VP_DEVICE=1."""
    from rpe_tpu.pipeline.batch import BatchProcessor as JBP
    from rpe_tpu.pipeline.estimator import PoseEstimator as JPE
    from rpe_tpu.pipeline.ground_truth import GroundTruthLoader as JGT
    from rpe_tpu_torch.pipeline.batch import BatchProcessor as TBP
    from rpe_tpu_torch.pipeline.estimator import PoseEstimator as TPE
    from rpe_tpu_torch.pipeline.ground_truth import GroundTruthLoader as TGT
    from rpe_tpu_torch.utils.synthetic import write_dataset

    frames, K, S, yaw, C = room
    root = write_dataset(tmp_path_factory.mktemp("vpseq"), frames, yaw, C)
    n = frames.shape[0]
    g = np.random.default_rng(4)
    R_rel = np.stack([jvp._so3_exp_np(g.normal(size=3) * 0.01) @ S
                      for _ in range(n - 1)])
    t_rel = np.tile([0.0, 0.0, 1.0], (n - 1, 1))
    pairs = (R_rel, t_rel, np.ones(n - 1, bool), np.full(n - 1, 100))
    # permissive gates so that the LM runs; max_pairs low enough that
    # every frame votes in the sampled regime
    kw = dict(use_vp_refinement=True, vp_acc_min=0.0, vp_vp2_min=0.0,
              vp_max_pairs=2000)

    def fake(self, frames_, imgs):
        return tuple(np.array(a) for a in pairs)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JBP, "_estimate_all_pairs", fake)
        mp.setattr(TBP, "_estimate_all_pairs", fake)
        for twin, env in (("host", None), ("device", "1")):
            if env:
                mp.setenv("RPE_VP_DEVICE", env)
            jgt, tgt = JGT(root / "camera_poses.txt"), TGT(root /
                                                           "camera_poses.txt")
            jgt.load()
            tgt.load()
            ref = JBP(root / "images", JPE(K, **kw), jgt).process_sequence(
                list(range(n)))
            proc = TBP(root / "images", TPE(K, device="cpu", **kw), tgt)
            got = proc.process_sequence(list(range(n)))
            out[twin] = ref, got, proc
    return pairs, out


@pytest.mark.parametrize("twin,tol", [("host", 1e-6), ("device", 1e-3)])
def test_process_sequence_with_vp(room, sequence, twin, tol):
    """Each frame's VP statistics (rtol 1e-9 and the same winning bins for
    the host twin; rtol 2e-4 and directions within 1e-5 for the tensor
    twin), the same pairs refined (those whose R is not the reference's
    anchor @ R_rel), and R entries within `tol` on the pairs whose LM starts
    within 1 rad of its optimum, with Euler angles within 1e-4 deg (host)
    or `tol` in degrees (device) there.

    `tol` is 1e-3 for the tensor twin: its directions are float32 (bin
    centres through float32 sines), and 12 LM steps carry their last-bit
    difference to R. Under these permissive gates some pairs start from
    directions that disagree by a column swap (initial cost > 3 rad); their
    LM path follows the last bit of the float32 GT anchor, whose sine
    differs between XLA and PyTorch, and they are held to 1e-2."""
    from rpe_tpu.geometry.rotations import euler_to_rotation

    (R_rel, _, _, _), out = sequence
    ref, got, proc = out[twin]
    assert got["frames"] == ref["frames"]
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    yaw = room[3][:-1]
    R_prev = np.asarray(euler_to_rotation(yaw, 0 * yaw, 0 * yaw,
                                          convention="yup"))
    R_ref = np.stack(ref["R"])
    R_got = np.stack(got["R"])
    ref_used = np.abs(R_ref - R_prev @ R_rel).max(axis=(1, 2)) > 1e-9
    assert len(proc.vp_frames) == 10
    np.testing.assert_array_equal(proc.vp_used, ref_used)
    assert ref_used.sum() >= 3

    frames, K = room[0], room[1]
    cfg = JVp(enabled=True, max_pairs=2000)
    dirs = (jvp.manhattan_dirs_for_frames if twin == "host"
            else jvp.manhattan_dirs_for_frames_device)
    want = []
    for s in (0, 8):
        blk = frames[s:s + 8]
        pad = 8 - blk.shape[0]
        blk = np.concatenate([blk, np.repeat(blk[-1:], pad, axis=0)])
        want += dirs(blk, K.astype(np.float64), cfg)[:8 - pad]
    for (D1, ok1, d1), (D2, ok2, d2) in zip(want, proc.vp_frames):
        assert ok2 == ok1 and d2["num_lines"] == d1["num_lines"]
        if twin == "host":
            # segments within 1e-8 px (tests/test_torch_lsd.py): the votes
            # agree to rounding, the winning bins exactly
            for k in ("acc_max", "vp2_score"):
                np.testing.assert_allclose(d2[k], d1[k], rtol=1e-9)
            if ok1:
                np.testing.assert_array_equal(D2, D1)
        else:
            for k in ("acc_max", "vp2_score"):
                np.testing.assert_allclose(d2[k], d1[k], rtol=2e-4)
            if ok1:
                np.testing.assert_allclose(D2, D1, rtol=0, atol=1e-5)

    near = np.ones(9, bool)
    for i in range(9):
        if ref_used[i]:
            Dp, Dn = want[i][0], want[i + 1][0]
            near[i] = jvp.vp_cost(R_prev[i] @ R_rel[i], Dn,
                                  R_prev[i].T @ Dp) < 1.0
    assert (near & ref_used).sum() >= 1
    np.testing.assert_allclose(R_got[near], R_ref[near], rtol=0, atol=tol)
    np.testing.assert_allclose(R_got, R_ref, rtol=0, atol=1e-2)
    atol = 1e-4 if twin == "host" else np.degrees(tol)
    for k in ("roll", "pitch", "yaw"):
        np.testing.assert_allclose(got[k][near], ref[k][near], rtol=0,
                                   atol=atol)
