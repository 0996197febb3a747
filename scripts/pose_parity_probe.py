#!/usr/bin/env python3
"""How far the port's pose stage lands from the reference's on identical
matches, per PRNG key, on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/pose_parity_probe.py   # ~2 min

Both packages get the reference's own detections of a small seeded scene
(the scenes and configurations of the parity tests): SIFT (3 frames of
120x400, 512 slots, no DEGENSAC, tests/test_torch_sift.py) with L2
cross-check (config A) and the L2 Lowe ratio test (config B), and ORB (3 frames of 160x320, 256 features,
tests/test_torch_pipeline.py) with cross-check (the main path's matcher)
and with the Hamming ratio test, with and without DEGENSAC. For keys
(10 s, 10 s + 1), s = 0..3, it prints per pair: whether the matches and
the inlier masks are identical, both inlier
counts, the rotation between the two poses and each one's error against
the scene's ground truth, and, where the inlier masks agree, how far apart
the two essential matrices are (unit Frobenius norm, sign aligned).
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import rpe_tpu.config as jcfg  # noqa: E402
from rpe_tpu.geometry.ransac import ransac_essential as j_ransac  # noqa: E402
from rpe_tpu.pipeline import estimator as jest  # noqa: E402
from rpe_tpu_torch import convert  # noqa: E402
from rpe_tpu_torch.geometry.epipolar import normalize_points  # noqa: E402
from rpe_tpu_torch.geometry.ransac import ransac_essential as t_ransac  # noqa: E402,E501
from rpe_tpu_torch.pipeline import estimator as test_  # noqa: E402
from rpe_tpu_torch.utils.synthetic import make_sequence, \
    rotation_error_deg  # noqa: E402


def _configs():
    sift = dict(feature_method="SIFT", sift=jcfg.SiftConfig(max_kpts=512),
                ransac=jcfg.RansacConfig(num_hypotheses=64, degensac=False))
    orb = dict(orb=jcfg.OrbConfig(nfeatures=256, nlevels=4, max_kpts=256),
               ransac=jcfg.RansacConfig(num_hypotheses=64))
    l2 = dict(norm_type="l2", max_matches=128)
    return [
        ("SIFT A", (120, 400, 4), jcfg.EstimatorConfig(
            matcher=jcfg.MatcherConfig(cross_check=True, **l2), **sift)),
        ("SIFT B", (120, 400, 4), jcfg.EstimatorConfig(
            matcher=jcfg.MatcherConfig(cross_check=False, **l2), **sift)),
        ("ORB cross-check, DEGENSAC", (160, 320, 1), jcfg.EstimatorConfig(
            matcher=jcfg.MatcherConfig(max_matches=128), **orb)),
        ("ORB ratio, DEGENSAC", (160, 320, 1), jcfg.EstimatorConfig(
            matcher=jcfg.MatcherConfig(cross_check=False, max_matches=128),
            **orb)),
        ("ORB ratio, no DEGENSAC", (160, 320, 1), jcfg.EstimatorConfig(
            matcher=jcfg.MatcherConfig(cross_check=False, max_matches=128),
            **dict(orb, ransac=jcfg.RansacConfig(num_hypotheses=64,
                                                 degensac=False)))),
    ]


def _essential_gap(jc, K, keys, got):
    """Max |E_port - E_ref| per pair (unit norm, sign aligned) from both
    packages' RANSAC on the port's matched points."""
    n1 = normalize_points(got["pts1"], torch.from_numpy(K))
    n2 = normalize_points(got["pts2"], torch.from_numpy(K))
    thr = np.float32(jc.ransac.threshold_px / (0.5 * (K[0, 0] + K[1, 1])))
    kw = dict(num_hypotheses=jc.ransac.num_hypotheses,
              refit_rounds=jc.ransac.refit_rounds, solver=jc.ransac.solver,
              degensac=jc.ransac.degensac)

    def one(k, a, b, m):
        with jax.default_matmul_precision("highest"):
            return j_ransac(k, a, b, m, thr, **kw)["E"]

    Ej = np.asarray(jax.jit(jax.vmap(one))(
        jnp.asarray(keys), jnp.asarray(n1.numpy()), jnp.asarray(n2.numpy()),
        jnp.asarray(got["match_valid"].numpy())))
    Et = t_ransac(convert.keys_from_numpy(keys), n1, n2, got["match_valid"],
                  torch.full((len(keys),), float(thr)), **kw)["E"].numpy()
    Ej = Ej / np.linalg.norm(Ej, axis=(1, 2), keepdims=True)
    Et = Et / np.linalg.norm(Et, axis=(1, 2), keepdims=True)
    sign = np.sign((Ej * Et).sum((1, 2)))[:, None, None]
    return np.abs(Ej - sign * Et).max(axis=(1, 2))


def main():
    jax.config.update("jax_platforms", "cpu")
    dets = {}
    for label, (h, w, seed), jc in _configs():
        frames, K, (R_gt, _) = make_sequence(3, h, w, seed=seed)
        key = (h, w, seed, jc.feature_method)
        if key not in dets:
            dets[key] = {k: np.asarray(v) for k, v in jax.jit(
                lambda ims: jax.lax.map(
                    lambda im: jest.detect_features(im, jc), ims))(
                jnp.asarray(frames)).items()}
        stack = dets[key]
        td = convert.detections_from_numpy(stack)
        tc = convert.config_from_dict(dataclasses.asdict(jc))
        ref_fn = jax.jit(jax.vmap(lambda d1, d2, k: jest._match_to_pose(
            d1, d2, jnp.asarray(K), k, jc)))
        for s in range(4):
            keys = np.asarray(jax.vmap(jax.random.PRNGKey)(
                np.arange(2) + 10 * s))
            ref = {k: np.asarray(v) for k, v in ref_fn(
                {k: v[:-1] for k, v in stack.items()},
                {k: v[1:] for k, v in stack.items()},
                jnp.asarray(keys)).items()}
            got = test_._match_to_pose(
                {k: v[:-1] for k, v in td.items()},
                {k: v[1:] for k, v in td.items()}, torch.from_numpy(K),
                convert.keys_from_numpy(keys), tc)
            g = {k: v.numpy() for k, v in got.items()}
            same_m = np.array_equal(g["pts1"], ref["pts1"]) and \
                np.array_equal(g["pts2"], ref["pts2"])
            same_i = (g["inlier_mask"] == ref["inlier_mask"]).all(-1)
            gap = _essential_gap(jc, K, keys, got)
            print(f"{label} keys {10 * s},{10 * s + 1}: matches identical "
                  f"{same_m}, inlier masks identical {same_i.tolist()}, "
                  f"inliers ref {ref['num_inliers'].tolist()} port "
                  f"{g['num_inliers'].tolist()}, R port vs ref (deg) "
                  f"{np.round(rotation_error_deg(g['R'], ref['R']), 4)}, "
                  f"vs ground truth ref "
                  f"{np.round(rotation_error_deg(ref['R'], R_gt[None]), 4)}"
                  f" port "
                  f"{np.round(rotation_error_deg(g['R'], R_gt[None]), 4)}, "
                  f"max |dE| {gap}", flush=True)


if __name__ == "__main__":
    main()
