"""The rpe_tpu_torch ORB path end to end against rpe_tpu on the CPU: the
back half (_match_to_pose) fed the reference's own detections through
rpe_tpu_torch/convert.py, with Hamming cross-check and the Hamming Lowe
ratio test, and the whole sequence path at a small size, also with
LO-RANSAC and OpenCV's BRIEF pattern; plus the port's entry-point rules
(device policy, failures, options). The SIFT
paths are held in tests/test_torch_sift.py."""

import dataclasses
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpe_tpu.config as jcfg
from rpe_tpu.pipeline import estimator as jest
from rpe_tpu_torch import config as tcfg
from rpe_tpu_torch import convert, rng
from rpe_tpu_torch.ops.orb import _ic_angle_masks
from rpe_tpu_torch.pipeline import estimator as test_
from rpe_tpu_torch.utils.synthetic import make_sequence, rotation_error_deg
from torch_gates import default_extraction_gates  # noqa: F401
from torch_gates import one_torch_thread  # noqa: F401

H, W = 160, 320
ROOT = Path(__file__).resolve().parents[1]


def _cfgs(cross_check=True):
    kw = dict(orb=dict(nfeatures=256, nlevels=4, max_kpts=256),
              matcher=dict(max_matches=128, cross_check=cross_check),
              ransac=dict(num_hypotheses=64, degensac=True))
    jc = jcfg.EstimatorConfig(**{k: getattr(jcfg, c)(**v) for (k, v), c in zip(
        kw.items(), ("OrbConfig", "MatcherConfig", "RansacConfig"))})
    return jc, convert.config_from_dict(dataclasses.asdict(jc))


@pytest.fixture(scope="module")
def scene():
    frames, K, (R, t) = make_sequence(3, H, W, seed=1)
    keys = np.asarray(jax.vmap(jax.random.PRNGKey)(np.arange(2)))
    return frames, K, R, keys


@pytest.fixture(scope="module")
def reference_detections(scene):
    jc, _ = _cfgs()
    stack = jax.jit(lambda ims: jax.lax.map(
        lambda im: jest.detect_features(im, jc), ims))(jnp.asarray(scene[0]))
    return {k: np.asarray(v) for k, v in stack.items()}


def test_match_to_pose_on_reference_detections(scene, reference_detections):
    frames, K, _, keys = scene
    jc, tc = _cfgs()
    stack = reference_detections
    ref = jax.jit(jax.vmap(lambda d1, d2, k: jest._match_to_pose(
        d1, d2, jnp.asarray(K), k, jc)))(
        {k: v[:-1] for k, v in stack.items()},
        {k: v[1:] for k, v in stack.items()}, jnp.asarray(keys))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    td = convert.detections_from_numpy(stack)
    got = test_._match_to_pose({k: v[:-1] for k, v in td.items()},
                               {k: v[1:] for k, v in td.items()},
                               torch.from_numpy(K),
                               convert.keys_from_numpy(keys), tc)
    got = {k: v.numpy() for k, v in got.items()}
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].shape == ref[k].shape, k
    assert ref["num_matches"].min() >= 30
    np.testing.assert_array_equal(got["num_matches"], ref["num_matches"])
    np.testing.assert_array_equal(got["match_valid"], ref["match_valid"])
    np.testing.assert_array_equal(got["pts1"], ref["pts1"])
    np.testing.assert_array_equal(got["pts2"], ref["pts2"])
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    assert np.abs(got["num_inliers"] - ref["num_inliers"]).max() <= 1
    assert rotation_error_deg(got["R"], ref["R"]).max() < 0.01


def test_ratio_matches_on_reference_detections(reference_detections):
    """The Hamming Lowe ratio test (ORB, cross_check=False) on the
    reference's detections: the same matches, bit for bit. (On such match
    sets RANSAC with DEGENSAC can land elsewhere in the two packages on
    some pairs: ROADMAP Queue 3.)"""
    jc, tc = _cfgs(cross_check=False)
    stack = reference_detections
    ref = jax.jit(jax.vmap(lambda d1, d2: jest.match_features(d1, d2, jc)))(
        {k: v[:-1] for k, v in stack.items()},
        {k: v[1:] for k, v in stack.items()})
    td = convert.detections_from_numpy(stack)
    got = test_.match_features({k: v[:-1] for k, v in td.items()},
                               {k: v[1:] for k, v in td.items()}, tc)
    assert int(np.asarray(ref["valid"]).sum(-1).min()) >= 30
    for k in ("idx1", "idx2", "dist", "valid"):
        np.testing.assert_array_equal(np.asarray(ref[k]), got[k].numpy(),
                                      err_msg=k)


def _hold_sequence_slice(scene, jc, tc):
    frames, K, R_gt, keys = scene
    ref = {k: np.asarray(v) for k, v in jest.estimate_sequence_batched(
        jnp.asarray(frames), jnp.asarray(K), jnp.asarray(keys),
        cfg=jc).items()}
    got = {k: v.numpy() for k, v in test_.estimate_sequence_batched(
        frames, K, keys, tc, device="cpu").items()}
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    assert got["valid"].all()
    assert rotation_error_deg(got["R"], ref["R"]).max() < 0.5
    assert rotation_error_deg(got["R"], R_gt[None]).max() < 2.0


def test_sequence_slice_matches_reference(scene):
    _hold_sequence_slice(scene, *_cfgs())


@pytest.mark.parametrize("profile", ["orb1000", "orb512"])
def test_sequence_slice_matches_reference_at_profiles(scene, profile):
    """The work-cut profiles (band 8, fewer levels and keypoints; orb512
    also 256 matches and 128 hypotheses) end to end, with the contracts of
    the test above."""
    _hold_sequence_slice(scene, jcfg.profile_config(profile),
                         tcfg.profile_config(profile))


def test_entry_points_need_a_card_unless_cpu_is_asked(monkeypatch, scene):
    frames, K, _, keys = scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        test_.estimate_sequence_batched(frames, K, keys)
    with pytest.raises(RuntimeError, match="CUDA"):
        test_.PoseEstimator(K)


def test_pose_estimator_api_and_failures(scene):
    frames, K, _, _ = scene
    _, tc = _cfgs()
    est = test_.PoseEstimator(K, nfeatures=256, max_matches=128, config=tc,
                              device="cpu")
    R, t = est.estimate(frames[0], frames[1])
    assert R.shape == (3, 3) and t.shape == (3, 1) and R.dtype == np.float64
    assert np.abs(R @ R.T - np.eye(3)).max() < 1e-4
    blank = np.zeros((H, W), np.float32)
    with pytest.raises(RuntimeError, match="Insufficient matches"):
        est.estimate(blank, blank)
    # a static pair: the zero-motion gate returns the identity pose
    out = test_.estimate_pair(frames[0], frames[0], K, rng.PRNGKey(0),
                              cfg=tc, device="cpu")
    assert bool(out["valid"]) and torch.equal(out["R"], torch.eye(3))


def test_vp_estimator_without_R_prev_is_the_plain_pose(scene):
    """The reference applies VP only when R_prev is given
    (rpe_tpu/pipeline/estimator.py:328), and its single-pair runner never
    passes it: the VP-on estimator returns the VP-off estimator's output,
    with vp_used=False."""
    frames, K, _, _ = scene
    _, tc = _cfgs()
    kw = dict(nfeatures=256, max_matches=128, config=tc, device="cpu",
              seed=3)
    off = test_.PoseEstimator(K, **kw).estimate_with_debug(frames[0],
                                                           frames[1])
    on = test_.PoseEstimator(K, use_vp_refinement=True, **kw)
    assert on.config.vp.enabled
    got = on.estimate_with_debug(frames[0], frames[1])
    assert got["vp_used"] is False and got["vp_debug"] == {}
    assert got.keys() == off.keys()
    for k in ("R", "t", "pts1", "pts2"):
        np.testing.assert_array_equal(got[k], off[k], err_msg=k)
    assert (got["num_matches"], got["inliers"]) == (off["num_matches"],
                                                    off["inliers"])


@pytest.mark.parametrize("change", ["orb_l2", "lo", "vp", "cv2_brief"])
def test_unported_options_raise(monkeypatch, scene, change):
    """The options beside the default path: ORB with L2 matching refuses
    with a clear error; VP refinement runs its gated refinement
    (tests/test_torch_vp.py holds it to the reference); LO-RANSAC
    (RansacConfig(lo=True)) holds the sequence slice to the reference
    (`_hold_sequence_slice`); under OpenCV's BRIEF pattern (RPE_BRIEF=cv2,
    rounding on by default; the reference traced anew, so it reads the
    pattern) the detections and matches are the reference's bit for bit,
    `valid` equal and the pose of the pair the 5-point roots do not
    decide within 0.5 deg."""
    frames, K, _, keys = scene
    jc, tc = _cfgs()
    if change == "vp":
        est = test_.PoseEstimator(K, use_vp_refinement=True, device="cpu")
        got = est.estimate_with_debug(frames[0], frames[1], R_prev=np.eye(3))
        assert {"prev_frame", "new_frame", "reliability"} <= \
            set(got["vp_debug"])
        plain = test_.PoseEstimator(K, device="cpu").estimate_with_debug(
            frames[0], frames[1])
        if not got["vp_used"]:
            np.testing.assert_array_equal(got["R"], plain["R"])
        return
    if change == "orb_l2":
        # ORB has no float descriptors: a clear ValueError, not a KeyError
        cfg = dataclasses.replace(tc, matcher=dataclasses.replace(
            tc.matcher, norm_type="l2"))
        with pytest.raises(ValueError, match="'desc' descriptors"):
            test_.estimate_sequence_batched(frames, K, keys, cfg,
                                            device="cpu")
        return
    if change == "lo":
        jc = dataclasses.replace(jc, ransac=dataclasses.replace(
            jc.ransac, lo=True))
        tc = dataclasses.replace(tc, ransac=dataclasses.replace(
            tc.ransac, lo=True))
        _hold_sequence_slice(scene, jc, tc)
        return
    # RPE_BRIEF=cv2: detections and matches bit for bit, and the sequence
    # slice's `valid` and pair 1's pose (<= 0.5 deg). Pair 0 draws a match
    # twice in 5 of its 64 minimal samples, and the unconverged 5-point
    # roots there decide its winner in either package (ROADMAP Known
    # divergences; scripts/degensac_handover.py on this pair: handed the
    # reference's 5-point output, the port ends on its E within 4.2e-8)
    monkeypatch.setenv("RPE_BRIEF", "cv2")
    jax.clear_caches()
    try:
        dets_j = {k: np.asarray(v) for k, v in jax.jit(
            lambda ims: jax.lax.map(lambda im: jest.detect_features(im, jc),
                                    ims))(jnp.asarray(frames)).items()}
        dets = test_.detect_features(torch.from_numpy(frames), tc)
        for k in ("xy", "valid", "bits"):
            np.testing.assert_array_equal(dets[k].numpy(), dets_j[k],
                                          err_msg=k)
        m_j = jax.jit(jax.vmap(lambda d1, d2: jest.match_features(d1, d2,
                                                                  jc)))(
            {k: v[:-1] for k, v in dets_j.items()},
            {k: v[1:] for k, v in dets_j.items()})
        m = test_.match_features({k: v[:-1] for k, v in dets.items()},
                                 {k: v[1:] for k, v in dets.items()}, tc)
        for k in ("idx1", "idx2", "valid"):
            np.testing.assert_array_equal(m[k].numpy(), np.asarray(m_j[k]),
                                          err_msg=k)
        ref = jest.estimate_sequence_batched(
            jnp.asarray(frames), jnp.asarray(K), jnp.asarray(keys), cfg=jc)
        got = test_.estimate_sequence_batched(frames, K, keys, tc,
                                              device="cpu")
        np.testing.assert_array_equal(got["valid"].numpy(),
                                      np.asarray(ref["valid"]))
        assert got["valid"].all()
        assert rotation_error_deg(got["R"][1].numpy(),
                                  np.asarray(ref["R"])[1]) < 0.5
    finally:
        jax.clear_caches()


@pytest.mark.parametrize("case", ["no_card", "alone"])
def test_chip_smoke_phases_and_refusals(tmp_path, case):
    """chip_smoke.py fails before doing any work, and prints no result,
    without a card (hidden from the process, so this holds on any host) or
    without the repo beside it."""
    script = ROOT / "chip_smoke.py"
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    if case == "alone":
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = tmp_path / "chip_smoke.py"
    r = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=600)
    assert '"ok": true' not in r.stdout
    assert r.returncode == 1
    assert ("is_available() is false" if case == "no_card"
            else "not found") in r.stderr


def _smoke_module():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _random_slots(g, band, patch=31):
    f, nb, cap, ha, wp = 2, 6, 5, 6 * band + 40, 90
    tbl_x0 = g.integers(0, wp - patch + 4, size=(f, nb, cap)).astype(np.int32)
    rel_y = g.integers(0, band, size=(f, nb, cap)).astype(np.int32)
    rel_y[g.random(size=rel_y.shape) < 0.3] = -31
    return tbl_x0, rel_y, ha, wp


def _brute_union(tbl_x0, rel_y, band, ha, wp, feet, patch=31):
    """Set union of (frame, row, col) that the l-th live slot reads at its
    patch indices feet[l] (clamped to the atlas)."""
    want = set()
    for l, (i, b, c) in enumerate(zip(*np.nonzero(rel_y >= 0))):
        y0, x0 = b * band + rel_y[i, b, c], tbl_x0[i, b, c]
        for k in feet[l]:
            want.add((i, min(y0 + k // patch, ha - 1),
                      min(x0 + k % patch, wp - 1)))
    return len(want)


@pytest.mark.parametrize("band", [8, 32])
def test_chip_smoke_k2_bound_counts_the_union_of_live_patches(band):
    """The extraction byte bounds read each atlas pixel under a live slot's
    whole patch, or under its IC mask, once: held against a brute-force
    set union on random band tables."""
    smoke = _smoke_module()
    tbl_x0, rel_y, ha, wp = _random_slots(np.random.default_rng(band), band)
    n_live = int((rel_y >= 0).sum())
    args = (torch, torch.from_numpy(tbl_x0), torch.from_numpy(rel_y), band,
            ha, wp)
    whole = np.arange(31 * 31)
    ic = np.flatnonzero(_ic_angle_masks()[0])
    for foot in (whole, ic):
        got = smoke.union_px(*args, torch.from_numpy(foot))
        want = _brute_union(tbl_x0, rel_y, band, ha, wp, [foot] * n_live)
        assert got == want > 0
    assert smoke.union_px(*args, torch.from_numpy(ic)) < smoke.union_px(
        *args, torch.from_numpy(whole))


@pytest.mark.parametrize("band", [8, 32])
def test_chip_smoke_bound_counts_each_slots_own_samples(band):
    """With a footprint per live slot (K2's rotated samples, K12's bin
    row), each slot adds only its own pixels to the union."""
    smoke = _smoke_module()
    g = np.random.default_rng(100 + band)
    tbl_x0, rel_y, ha, wp = _random_slots(g, band)
    n_live = int((rel_y >= 0).sum())
    feet = g.integers(0, 31 * 31, size=(n_live, 40))
    got = smoke.union_px(torch, torch.from_numpy(tbl_x0),
                         torch.from_numpy(rel_y), band, ha, wp,
                         torch.from_numpy(feet))
    assert got == _brute_union(tbl_x0, rel_y, band, ha, wp, feet) > 0


def test_config_defaults_are_the_parity_config():
    assert tcfg.EstimatorConfig() == convert.config_from_dict(
        dataclasses.asdict(jcfg.EstimatorConfig()))
