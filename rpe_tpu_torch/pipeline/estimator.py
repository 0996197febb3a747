"""Relative-pose estimator: detect -> match -> RANSAC -> recoverPose
(port of rpe_tpu/pipeline/estimator.py).

The functional core runs on static shapes with validity masks, and a
degenerate pair surfaces as `valid=False` with an identity pose instead of
an exception. Where the reference maps detection over frames and vmaps the
pair stage, the port batches: all frames of a call go through detection
together (ORB: one launch each of K1 and K2; SIFT: one each of P3 and
P4 per octave) and all pairs through matching and RANSAC together (one
launch of the matcher's kernel -- K3 Hamming or K7 L2 cross-check, K6 for
the Lowe ratio test -- and one of K4).

Entry points take `device=None`, meaning the CUDA card (utils/device.py),
and set full float32 matmul precision before any work. `PoseEstimator`
keeps the reference's exception-raising single-pair API.

Under a torch profiler a call's work falls in four spans, one after
another (utils/observability.py `span`): "rpe.detect" (detection),
"rpe.match" (matching and the gathers of matched points), "rpe.ransac"
(normalization and RANSAC with DEGENSAC and the ambiguity blend) and
"rpe.pose" (recoverPose, the audits, the zero-motion gate and the final
selection). Every launch of a call whose inputs are on its device lies in
exactly one; inputs given on the host are copied before the first.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import rng
from ..config import EstimatorConfig
from ..convert import keys_from_numpy
from ..geometry.epipolar import normalize_points
from ..geometry.ransac import ransac_essential
from ..geometry.recover_pose import recover_pose
from ..ops.match import match_hamming, match_l2, match_ratio
from ..ops.orb import orb_detect_and_describe
from ..ops.sift import sift_detect_and_describe
from ..utils.device import full_precision, resolve_device
from ..utils.observability import htod, span
from ..utils.sanitize import audit_finite, audit_rotation


def detect_features(imgs, cfg: EstimatorConfig):
    """ORB or SIFT on a batch of frames (F, H, W) float32 -> dict of
    (F, K, ...): ORB carries 256 {0,1} "bits", SIFT 128 float "desc"."""
    method = cfg.feature_method.upper()
    if method == "ORB":
        o = cfg.orb
        return orb_detect_and_describe(
            imgs, nfeatures=o.nfeatures, nlevels=o.nlevels,
            scale_factor=o.scale_factor, fast_threshold=o.fast_threshold,
            max_kpts=o.max_kpts, extract_cap=o.extract_cap, band=o.band)
    if method == "SIFT":
        return sift_detect_and_describe(imgs, cfg.sift)
    raise ValueError(
        f"Unknown feature extraction method: {cfg.feature_method}")


def match_features(det1, det2, cfg: EstimatorConfig):
    """Matching of paired detections (P, K, ...): cross-check (Hamming on
    "bits", squared L2 on "desc") or, with cross_check=False, the Lowe
    ratio test (on squared L2 distances the ratio is squared)."""
    m = cfg.matcher
    norm = m.norm_type.lower()
    if norm not in ("hamming", "l2"):
        raise ValueError(f"Unknown norm type: {m.norm_type}")
    key = "bits" if norm == "hamming" else "desc"
    if key not in det1:
        raise ValueError(
            f"norm_type {m.norm_type!r} matches {key!r} descriptors, which "
            f"these detections do not have ({sorted(det1)}): ORB pairs with "
            f"hamming, SIFT with l2")
    d1, d2, v1, v2 = det1[key], det2[key], det1["valid"], det2["valid"]
    if m.cross_check:
        match = match_hamming if norm == "hamming" else match_l2
        return match(d1, d2, v1, v2, max_matches=m.max_matches)
    ratio = m.ratio if norm == "hamming" else m.ratio ** 2
    return match_ratio(d1, d2, v1, v2, ratio=ratio,
                       max_matches=m.max_matches, norm=norm)


def zero_motion_gate(pts1, pts2, mvalid, num_matches, zm_px: float):
    """True per pair when the median pixel flow over the valid matches is
    below `zm_px` (with at least 8 matches): a static pair, whose essential
    matrix is undefined."""
    flow2 = ((pts2 - pts1) ** 2).sum(-1)                     # (P, M)
    fl = torch.sort(torch.where(mvalid, flow2, torch.inf), dim=-1).values
    mid = (torch.clamp_min(num_matches - 1, 0) // 2).long()
    med2 = torch.gather(fl, -1, mid[:, None])[:, 0]
    return (num_matches >= 8) & (med2 < float(np.float32(zm_px) ** 2))


def _match_to_pose(det1, det2, K, keys, cfg: EstimatorConfig):
    """Match -> RANSAC -> recoverPose for P pairs of detections."""
    with span("rpe.match"):
        audit_finite("detect", xy1=det1["xy"], xy2=det2["xy"],
                     score1=det1["score"], score2=det2["score"])
        matches = match_features(det1, det2, cfg)
        pts1 = torch.gather(det1["xy"], 1,
                            matches["idx1"][..., None].expand(-1, -1, 2))
        pts2 = torch.gather(det2["xy"], 1,
                            matches["idx2"][..., None].expand(-1, -1, 2))
        mvalid = matches["valid"]
        num_matches = mvalid.sum(-1, dtype=torch.int32)
    p = pts1.shape[0]

    with span("rpe.ransac"):
        n1 = normalize_points(pts1, K)
        n2 = normalize_points(pts2, K)
        thr_n = cfg.ransac.threshold_px / (0.5 * (K[0, 0] + K[1, 1]))
        r = ransac_essential(
            keys, n1, n2, mvalid, thr_n.expand(p),
            num_hypotheses=cfg.ransac.num_hypotheses,
            refit_rounds=cfg.ransac.refit_rounds,
            solver=cfg.ransac.solver,
            degensac=cfg.ransac.degensac,
            lo=cfg.ransac.lo)

    with span("rpe.pose"):
        R, t, votes, _ = recover_pose(r["E"], n1, n2, mvalid,
                                      inlier_mask=r["inlier_mask"])
        audit_finite("ransac", E=r["E"])
        audit_rotation("recover_pose", R)
        valid = r["ok"] & (num_matches >= 5)
        if cfg.ransac.zero_motion_px > 0.0:
            zm = zero_motion_gate(pts1, pts2, mvalid, num_matches,
                                  cfg.ransac.zero_motion_px)
            valid = valid | zm
        else:
            zm = torch.zeros_like(valid)
        use = (valid & ~zm)
        eye = torch.eye(3, dtype=R.dtype, device=R.device)
        t001 = htod([0.0, 0.0, 1.0], t.device, t.dtype)
        R = torch.where(use[:, None, None], R, eye)
        t = torch.where(use[:, None], t, t001)
    return {
        "R": R, "t": t, "valid": valid,
        "num_matches": num_matches, "num_inliers": r["num_inliers"],
        "cheirality_votes": votes,
        "pts1": pts1, "pts2": pts2,
        "match_valid": mvalid, "inlier_mask": r["inlier_mask"],
    }


def _tensor(x, device, dtype):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _keys(keys, device):
    """JAX-layout keys ((..., 2) uint32 numpy or int64 tensor) -> int64."""
    if isinstance(keys, torch.Tensor):
        return keys.to(device=device, dtype=torch.int64)
    return keys_from_numpy(keys, device=device)


def _prepare(device, K, keys):
    dev = resolve_device(device)
    full_precision()
    return dev, _tensor(K, dev, torch.float32), _keys(keys, dev)


def estimate_pairs_batched(imgs1, imgs2, K, keys,
                           cfg: EstimatorConfig = EstimatorConfig(),
                           device=None):
    """Batched pair estimation: (B, H, W) x2 -> per-pair pose dict with a
    leading B axis. keys: (B, 2) threefry keys (rng.PRNGKey layout)."""
    dev, K, keys = _prepare(device, K, keys)
    imgs1 = _tensor(imgs1, dev, torch.float32)
    imgs2 = _tensor(imgs2, dev, torch.float32)
    b = imgs1.shape[0]
    with torch.no_grad():
        with span("rpe.detect"):
            dets = detect_features(torch.cat([imgs1, imgs2], dim=0), cfg)
        det1 = {k: v[:b] for k, v in dets.items()}
        det2 = {k: v[b:] for k, v in dets.items()}
        return _match_to_pose(det1, det2, K, keys, cfg)


def estimate_sequence_batched(imgs, K, keys,
                              cfg: EstimatorConfig = EstimatorConfig(),
                              device=None):
    """Consecutive-pair estimation over a frame chunk: (B+1, H, W) -> B
    pairs (i, i+1). Each frame is detected once and shared by both of its
    pairs."""
    dev, K, keys = _prepare(device, K, keys)
    imgs = _tensor(imgs, dev, torch.float32)
    with torch.no_grad():
        with span("rpe.detect"):
            dets = detect_features(imgs, cfg)
        det1 = {k: v[:-1] for k, v in dets.items()}
        det2 = {k: v[1:] for k, v in dets.items()}
        return _match_to_pose(det1, det2, K, keys, cfg)


def estimate_pair(img1, img2, K, key, cfg: EstimatorConfig = EstimatorConfig(),
                  device=None):
    """One pair: (H, W) x2, key (2,) -> pose dict without a batch axis."""
    dev = resolve_device(device)
    out = estimate_pairs_batched(
        _tensor(img1, dev, torch.float32)[None],
        _tensor(img2, dev, torch.float32)[None], K,
        _keys(key, dev)[None], cfg=cfg, device=dev)
    return {k: v[0] for k, v in out.items()}


class PoseEstimator:
    """Reference-compatible single-pair API (rpe_tpu/pipeline/estimator.py
    `PoseEstimator`): RuntimeError on < 5 matches or essential-matrix
    failure. VP refinement runs when `use_vp_refinement` and `R_prev` are
    given (geometry/vp_refine.py, the host twin with per-role seeds 0 and 1,
    its labeling on the estimator's device), with the gated accept of the
    reference; without `R_prev` the plain pose comes back."""

    def __init__(
        self,
        camera_matrix,
        feature_method: str = "ORB",
        norm_type: str = "Hamming",
        max_matches: int = 500,
        nfeatures: int = 4000,
        use_vp_refinement: bool = False,
        vp_max_lines: int = 120,
        vp_max_pairs: int = 3000,
        vp_acc_min: float = 8e5,
        vp_vp2_min: float = 8000.0,
        vp_iters: int = 12,
        vp_lm_lambda: float = 1e-2,
        vp_cost_improve_eps: float = 1e-3,
        seed: int = 0,
        config: EstimatorConfig | None = None,
        device=None,
    ):
        if config is None:
            config = EstimatorConfig()
        config = dataclasses.replace(
            config,
            feature_method=feature_method,
            orb=dataclasses.replace(config.orb, nfeatures=nfeatures),
            matcher=dataclasses.replace(
                config.matcher, norm_type=norm_type.lower(),
                max_matches=max_matches),
            vp=dataclasses.replace(
                config.vp, enabled=use_vp_refinement, max_lines=vp_max_lines,
                max_pairs=vp_max_pairs, acc_min=vp_acc_min,
                vp2_min=vp_vp2_min, iters=vp_iters, lm_lambda=vp_lm_lambda,
                cost_improve_eps=vp_cost_improve_eps),
        )
        if config.matcher.norm_type not in ("hamming", "l2"):
            raise ValueError(f"Unknown norm type: {norm_type}")
        if config.feature_method.upper() not in ("ORB", "SIFT"):
            raise ValueError(
                f"Unknown feature extraction method: {feature_method}")
        self.K = np.asarray(camera_matrix, dtype=np.float32)
        self.config = config
        self.device = resolve_device(device)
        self._seed = seed
        self._counter = 0

    def _next_key(self):
        key = rng.PRNGKey(self._seed + self._counter)
        self._counter += 1
        return key

    def estimate(self, img1, img2, R_prev=None):
        """Relative pose as numpy (R (3, 3), t (3, 1)); RuntimeError on
        failure."""
        out = self.estimate_with_debug(img1, img2, R_prev)
        return out["R"], out["t"]

    def estimate_with_debug(self, img1, img2, R_prev=None):
        out = estimate_pair(img1, img2, self.K, self._next_key(),
                            cfg=self.config, device=self.device)
        num_matches = int(out["num_matches"])
        if num_matches < 5:
            raise RuntimeError(
                f"Insufficient matches: {num_matches} (minimum 5 required)")
        if not bool(out["valid"]):
            raise RuntimeError("Could not estimate Essential matrix.")
        mv = out["match_valid"].cpu().numpy()
        R_rel = out["R"].cpu().numpy().astype(np.float64)
        debug = {
            "R": R_rel,
            "t": out["t"].cpu().numpy().astype(np.float64).reshape(3, 1),
            "num_matches": num_matches,
            "pts1": out["pts1"].cpu().numpy()[mv],
            "pts2": out["pts2"].cpu().numpy()[mv],
            "inliers": int(out["cheirality_votes"]),
            "vp_used": False,
            "vp_debug": {},
        }
        if self.config.vp.enabled and R_prev is not None:
            from ..geometry.vp_refine import refine_rotation_with_vps

            R_ref, vp_used, vp_dbg = refine_rotation_with_vps(
                np.asarray(img1), np.asarray(img2),
                np.asarray(R_prev, dtype=np.float64), R_rel,
                self.K, self.config.vp, device=self.device)
            debug["vp_debug"] = vp_dbg
            if vp_used:
                debug["R"] = R_ref
                debug["vp_used"] = True
        return debug
