"""rpe_tpu_torch SIFT against rpe_tpu on the CPU, at a small size (3 seeded
synthetic frames of 120x400, 512 keypoint slots): the scale space, the
extrema/relocation stage and the orientation/descriptor stage on identical
inputs, detection end to end, and both SIFT pose paths -- L2 cross-check
(config A) and the L2 Lowe ratio test (config B) -- on the reference's own
detections and end to end. The same numpy arrays go to both packages.

Tolerances: XLA and PyTorch round blur sums, atan2, exp and cos/sin
differently by ULPs, so the scale space is held to 1e-5, keypoints to
1e-3 px and descriptors to a cosine of 0.999. The scale-space, detection
and pose tests print what they measured (`pytest -s`): 4.8e-7, 1.2e-4 px
and 0.999997 at this size."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rpe_tpu.config as jcfg
from rpe_tpu.ops import sift as jsift
from rpe_tpu.pipeline import estimator as jest
from rpe_tpu_torch import config as tcfg
from rpe_tpu_torch import convert
from rpe_tpu_torch.ops import sift as tsift
from rpe_tpu_torch.ops.orb import top_k_stable
from rpe_tpu_torch.pipeline import estimator as test_
from rpe_tpu_torch.utils.synthetic import make_sequence, rotation_error_deg

H, W, MAX_KPTS = 120, 400, 512


@pytest.fixture(scope="module")
def scene():
    frames, K, (R, _) = make_sequence(3, H, W, seed=4)
    keys = np.asarray(jax.vmap(jax.random.PRNGKey)(np.arange(2)))
    return frames, K, R, keys


@pytest.fixture(scope="module")
def reference(scene):
    cfg = jcfg.SiftConfig(max_kpts=MAX_KPTS)
    fn = jax.jit(lambda ims: jax.lax.map(
        lambda im: jsift.sift_detect_and_describe(im, cfg), ims))
    return {k: np.asarray(v) for k, v in fn(jnp.asarray(scene[0])).items()}


@pytest.fixture(scope="module")
def port(scene):
    out = tsift.sift_detect_and_describe(torch.from_numpy(scene[0]),
                                         tcfg.SiftConfig(max_kpts=MAX_KPTS))
    return {k: v.numpy() for k, v in out.items()}


def _reference_sigmas():
    """The reference's incremental level blurs (rpe_tpu/ops/sift.py:623-629),
    from its own constants."""
    k = 2.0 ** (1.0 / jsift._S)
    sig = [jsift._SIGMA0]
    for i in range(1, jsift._S + 3):
        prev = jsift._SIGMA0 * (k ** (i - 1))
        sig.append(math.sqrt((prev * k) ** 2 - prev ** 2))
    return sig


def _reference_octaves(img):
    """The reference's Gaussian octaves (rpe_tpu/ops/sift.py:611-641, 705)
    built from its own resize, base blur and `_blur`."""
    x = img.astype(jnp.float32) / 255.0
    h0, w0 = img.shape
    base = jax.image.resize(x, (h0 * 2, w0 * 2), method="linear")
    o = jsift._blur(base, math.sqrt(max(
        jsift._SIGMA0 ** 2 - (2 * jsift._INIT_SIGMA) ** 2, 0.01)))
    sig = _reference_sigmas()
    octaves = []
    while min(o.shape) >= 32:
        g = [o]
        for i in range(1, jsift._S + 3):
            g.append(jsift._blur(g[-1], sig[i]))
        octaves.append(jnp.stack(g))
        oh, ow = o.shape
        o = g[jsift._S][::2, ::2][: oh // 2, : ow // 2]
    return octaves


@pytest.fixture(scope="module")
def reference_octaves(scene):
    return [np.asarray(a)
            for a in jax.jit(_reference_octaves)(jnp.asarray(scene[0][0]))]


def test_scale_space_matches_reference(scene, reference_octaves):
    octaves = tsift.scale_space(torch.from_numpy(scene[0][:1]),
                                jcfg.SiftConfig().noctaves)
    assert [tuple(o.shape[1:]) for o in octaves] == \
        [o.shape for o in reference_octaves] == \
        [(6, 240, 800), (6, 120, 400), (6, 60, 200)]
    diff = 0.0
    for got, ref in zip(octaves, reference_octaves):
        np.testing.assert_allclose(got[0].numpy(), ref, atol=1e-5, rtol=0)
        diff = max(diff, float(np.abs(got[0].numpy() - ref).max()))
    print(f"octave stacks: max |diff| {diff:.3e}")


def test_octave_quotas_and_taps_match_reference():
    for args in [(4096, 6), (512, 6), (2048, 4)]:
        assert tsift.octave_quotas(*args) == jsift._octave_quotas(*args)
    assert tsift._level_sigmas() == _reference_sigmas()
    assert len(_reference_sigmas()) == jsift._S + 3


@pytest.mark.parametrize("octave", [0, 1, 2])
def test_extrema_and_relocation_on_identical_dogs(reference_octaves, octave):
    """Identical DoG stacks in: the same candidates survive relocation,
    contrast and edge checks, at the same layer, within float32 rounding."""
    _check_octave(reference_octaves, octave, "exact")


@pytest.mark.parametrize("select,octave", [("approx", 0), ("block2", 2)])
def test_select_modes_on_identical_dogs(reference_octaves, select, octave):
    """The reference's other extrema selections (`_detect_octave`'s
    `select`): "approx" (lax.approx_max_k, off the TPU the exact top-k)
    and "block2" (two first-index maxima per 128-element block, then the
    top-k of the winners; octave 2's 36000 values end in a padded block),
    held as the default selection is."""
    _check_octave(reference_octaves, octave, select)


def _check_octave(reference_octaves, octave, select):
    G = reference_octaves[octave]
    quota = jsift._octave_quotas(MAX_KPTS, 6)[octave]
    gauss = [jnp.asarray(g) for g in G]
    dogs = [gauss[i + 1] - gauss[i] for i in range(len(gauss) - 1)]
    xy_j, lay_j, score_j, valid_j, k_j = (np.asarray(a) for a in jax.jit(
        lambda g, d: jsift._detect_octave(g, d, quota, select=select))(
            gauss, dogs))
    D = torch.from_numpy(np.stack([np.asarray(d) for d in dogs]))[None]
    s0, flat = tsift.select_candidates(tsift.extrema_values(D), quota,
                                       select)
    if select != "block2":
        want = top_k_stable(tsift.extrema_values(D), quota)
        assert torch.equal(s0, want[0]) and torch.equal(flat, want[1])
    xy_t, lay_t, score_t, valid_t, k_t = (a[0].numpy() for a in
                                          tsift.refine_candidates(D, s0, flat))
    np.testing.assert_array_equal(valid_t, valid_j)
    v = valid_j
    assert v.sum() >= 10
    np.testing.assert_array_equal(k_t[v], k_j[v])
    np.testing.assert_allclose(xy_t[v], xy_j[v], atol=1e-4, rtol=0)
    np.testing.assert_allclose(lay_t[v], lay_j[v], atol=1e-4, rtol=0)
    np.testing.assert_allclose(score_t, score_j, rtol=1e-5, atol=1e-7)


def test_orientation_and_descriptor_on_identical_patches():
    g = np.random.default_rng(0)
    q = 200
    patches = jnp.asarray(g.uniform(0, 1, (q, 80, 80)).astype(np.float32))
    gxp, gyp = (np.asarray(a) for a in jsift._patch_grads(patches))
    ucx = g.uniform(30, 50, q).astype(np.float32)
    ucy = g.uniform(30, 50, q).astype(np.float32)
    scl = g.uniform(1.6, 4.0, q).astype(np.float32)
    valid = g.uniform(size=q) < 0.9
    args = (gxp, gyp, ucx, ucy, scl)
    th_j = [np.asarray(a) for a in jax.jit(jsift._orientation)(
        *map(jnp.asarray, args + (valid,)))]
    t_args = [torch.from_numpy(a)[None] for a in args]
    th_t = [a[0].numpy() for a in tsift.orientation_peaks(
        tsift.orientation_hist_plain(*t_args),
        torch.from_numpy(valid)[None])]
    np.testing.assert_allclose(th_t[0], th_j[0], atol=1e-4, rtol=0)
    np.testing.assert_array_equal(th_t[2], th_j[2])
    assert th_j[2].sum() > 0
    np.testing.assert_allclose(th_t[1][th_j[2]], th_j[1][th_j[2]], atol=1e-4,
                               rtol=0)
    theta = th_j[0]
    d_j = np.asarray(jax.jit(jsift._descriptor)(
        *map(jnp.asarray, args + (theta,))))
    d_t = tsift.descriptor_plain(
        *(torch.from_numpy(a)[None] for a in args + (theta,)))[0].numpy()
    np.testing.assert_allclose(d_t, d_j, atol=1e-5, rtol=0)


def test_detection_matches_reference(reference, port):
    """>= 98% of the reference's valid keypoints reappear within 1e-3 px at
    the same octave (paired by angle, since a secondary orientation shares
    its primary's position), >= 98% of those with descriptor cosine >=
    0.999; shapes, dtypes and zero padding follow the reference."""
    for k in reference:
        assert port[k].shape == reference[k].shape, k
        assert port[k].dtype == reference[k].dtype, k
    assert port["desc"].shape == (3, MAX_KPTS, 128)
    for i in range(3):
        _assert_reproduced({k: v[i] for k, v in reference.items()},
                           {k: v[i] for k, v in port.items()}, i)


@pytest.mark.parametrize("option", [{"upscale_first": False},
                                    {"select": "block2"}],
                         ids=["no_upscale", "block2"])
def test_detection_options_match_reference(scene, option):
    """The reference's options of `sift_detect_and_describe` end to end on
    frame 0, held as the default is (`_assert_reproduced`):
    upscale_first=False (no 2x upsample, base scale 1, sigma sqrt(1.6^2 -
    0.5^2)) and select="block2"."""
    ref = jax.jit(lambda im: jsift.sift_detect_and_describe(
        im, jcfg.SiftConfig(max_kpts=MAX_KPTS), **option))(
            jnp.asarray(scene[0][0]))
    got = tsift.sift_detect_and_describe(
        torch.from_numpy(scene[0][:1]), tcfg.SiftConfig(max_kpts=MAX_KPTS),
        **option)
    ref = {k: np.asarray(v) for k, v in ref.items()}
    got = {k: v[0].numpy() for k, v in got.items()}
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype
    _assert_reproduced(ref, got, 0)


def _assert_reproduced(r, t, i):
    """One frame's detections: >= 98% of the reference's valid keypoints
    reappear within 1e-3 px at the same octave, >= 98% of those with
    descriptor cosine >= 0.999, unit-norm descriptors, zero padding."""
    vr, vt = r["valid"], t["valid"]
    assert vr.sum() > 100
    near = (np.abs(r["xy"][vr][:, None] - t["xy"][vt][None]).max(-1)
            <= 1e-3) & (r["level"][vr][:, None] == t["level"][vt][None])
    da = np.abs((r["angle"][vr][:, None] - t["angle"][vt][None] + np.pi)
                % (2 * np.pi) - np.pi)
    cost = np.where(near, da, np.inf)
    j = cost.argmin(1)
    rows = np.arange(len(j))
    found = np.isfinite(cost[rows, j])
    assert found.mean() >= 0.98, (i, found.mean())
    cos = (r["desc"][vr][found] * t["desc"][vt][j[found]]).sum(-1)
    assert (cos >= 0.999).mean() >= 0.98, (i, (cos >= 0.999).mean())
    dxy = np.abs(r["xy"][vr][found] - t["xy"][vt][j[found]]).max()
    print(f"frame {i}: {int(vr.sum())} reference / {int(vt.sum())} port "
          f"valid keypoints, reproduced {found.mean():.4f}, max |dxy| "
          f"{dxy:.3e} px, min descriptor cosine {cos.min():.7f}")
    np.testing.assert_allclose(np.linalg.norm(t["desc"][vt], axis=1), 1.0,
                               atol=1e-4)
    n_slots = sum(jsift._octave_quotas(MAX_KPTS, 6)[:3])
    assert not t["valid"][n_slots:].any()
    assert not t["desc"][n_slots:].any() and not t["xy"][n_slots:].any()


# ---- the SIFT pose paths --------------------------------------------------------

def _cfgs(cross_check):
    """Config A (cross_check=True, L2 cross-check) or B (L2 Lowe ratio),
    cut to size: 512 slots, 128 matches, 64 RANSAC hypotheses, and no
    DEGENSAC (tests/test_torch_pipeline.py holds it on ORB; here it would
    double the reference's compile time)."""
    jc = jcfg.EstimatorConfig(
        feature_method="SIFT", sift=jcfg.SiftConfig(max_kpts=MAX_KPTS),
        matcher=jcfg.MatcherConfig(norm_type="l2", cross_check=cross_check,
                                   max_matches=128),
        ransac=jcfg.RansacConfig(num_hypotheses=64, degensac=False))
    return jc, convert.config_from_dict(dataclasses.asdict(jc))


@pytest.fixture(scope="module", params=[True, False], ids=["A", "B"])
def reference_pose(request, scene, reference):
    """The reference's pose stage on its own detections, per config: by
    construction (rpe_tpu/pipeline/estimator.py:214-221) also the
    reference's `estimate_sequence_batched` output on these frames."""
    _, K, _, keys = scene
    jc, tc = _cfgs(request.param)
    ref = jax.jit(jax.vmap(lambda d1, d2, k: jest._match_to_pose(
        d1, d2, jnp.asarray(K), k, jc)))(
        {k: v[:-1] for k, v in reference.items()},
        {k: v[1:] for k, v in reference.items()}, jnp.asarray(keys))
    return tc, {k: np.asarray(v) for k, v in ref.items()}


def test_sift_match_to_pose_on_reference_detections(scene, reference,
                                                    reference_pose):
    _, K, _, keys = scene
    tc, ref = reference_pose
    td = convert.detections_from_numpy(reference)
    assert td["desc"].dtype == torch.float32
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
    # config B: with identical matches and inlier masks the two essential
    # matrices agree to about 1e-6 on the second pair, and recover_pose turns
    # that into 0.0185 deg; config A measures 0.0 (printed below)
    tol = 0.01 if tc.matcher.cross_check else 0.05
    d_rot = rotation_error_deg(got["R"], ref["R"])
    print(f"config {'A' if tc.matcher.cross_check else 'B'}: inlier masks "
          f"identical {(got['inlier_mask'] == ref['inlier_mask']).all(-1)}, "
          f"R port vs reference (deg) {d_rot}")
    assert d_rot.max() < tol


def test_sift_sequence_matches_reference(scene, reference_pose):
    frames, K, R_gt, keys = scene
    tc, ref = reference_pose
    got = {k: v.numpy() for k, v in test_.estimate_sequence_batched(
        frames, K, keys, tc, device="cpu").items()}
    for k in ref:
        assert got[k].shape == ref[k].shape and got[k].dtype == ref[k].dtype, k
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    assert got["valid"].all()
    assert rotation_error_deg(got["R"], ref["R"]).max() < 0.5
    assert rotation_error_deg(got["R"], R_gt[None]).max() < 2.0


def test_sift_pose_estimator_api(scene):
    frames, K, _, _ = scene
    _, tc = _cfgs(True)
    est = test_.PoseEstimator(K, feature_method="SIFT", norm_type="L2",
                              max_matches=128, config=tc, device="cpu")
    assert est.config.feature_method == "SIFT"
    assert est.config.matcher.norm_type == "l2"
    dbg = est.estimate_with_debug(frames[0], frames[1])
    assert dbg["R"].shape == (3, 3) and dbg["num_matches"] >= 30
    assert len(dbg["pts1"]) == dbg["num_matches"]
