#!/usr/bin/env python3
"""Does a pair's pose depend on the batch it is estimated in?

A mesh of two shards, a `--chunk` of another size and the fallback's
re-runs estimate the same pairs in batches of other sizes. This script runs
the ORB path (`EstimatorConfig()`, or SIFT A with `--feature sift`; the
8-point solver with `--solver 8pt`) on one
1241x376 sequence of 33 frames (32 pairs) in one call and in chunks of 16,
8 and 1 pairs, and compares every stage on identical inputs, so that a
difference is traced to the first stage whose output depends on the batch:

  detect         detections of each chunk's frames (a chunk of c pairs
                 takes c + 1 frames) against the whole run's
  (SIFT only, before `detect`: its stages on the whole run's inputs of
  each chunk's frames, every octave; ops/sift.py)
  scale space    `scale_space` octaves
  extrema        `extrema_values`
  select         `select_candidates` (the stable top-k) on them
  refine         `refine_candidates`
  patches        `keypoint_patches`: `extract_patches`, `_patch_grads`
  orient sample  vx, vy of the orientation window (P3's samples)
  orient hist    the 36-bin histogram (P3)
  theta          `orientation_peaks`: theta1, theta2, has2
  reselect       `reselect`: the quota's re-selection
  desc sample    vx, vy of the descriptor window (P4's samples)
  desc hist      the 128 sums before normalising (P4)
  desc           after normalise, clip and renormalise (P4)
  match          matches of each pair, on identical detections
  (with `--solver 8pt`, in place of null4 ... project: its 8-point
  samples' normal matrices `8pt AtA`, their `smallest_eigvec_sym`
  `8pt eig`, and `hypotheses`, the projected E of `ransac.hypotheses`)
  null4          the Householder null space of the epipolar rows
  coeffs         `constraint_coeffs`: null4 and the constraint coefficients
  roots          K4's roots on identical coefficients
  candidates     `_assemble_candidates`: candidate E and their flags
  project        `project_to_essential` of the candidates
  score          per-hypothesis inliers, counts and truncated MSAC sums
  winner         the winning hypothesis and the scores
  refit AtA      the 8-point refit's normal matrix on the winner's inliers
  eig            `smallest_eigvec_sym` of it, `eigh3x3_desc` of E^T E
  project refit  `project_to_essential` of the winners
  lo             `local_optimization` (LO-RANSAC, off by default) of the
                 winner
  refit 1, 2     each `refit_round`
  dlt AtA        the DLT normal matrix of DEGENSAC's 4-point samples
  homography     `ransac_homography`
  gric           `gric_score` of the refit E's Sampson errors
  parallax       `plane_parallax_essentials`
  degensac       `degensac_rescue`
  ambig AtA      the ambiguity blend's refit normal matrix (top 16)
  ambiguity      `ambiguity_blend`
  decompose      `decompose_essential` of the final E
  triangulate    `triangulate_depths` of the four candidate poses
  recover_pose   `recover_pose` with the inlier ranking
  pose           `estimate_sequence_batched` end to end (R, t, valid,
                 num_inliers, num_matches)

    python3 scripts/batch_invariance_probe.py              # on the card
    python3 scripts/batch_invariance_probe.py --device cpu
    python3 scripts/batch_invariance_probe.py --feature sift
    python3 scripts/batch_invariance_probe.py --solver 8pt
    python3 scripts/batch_invariance_probe.py --feature sift --device cpu \
        --pairs 4 --size 120 400

Prints one line per stage: the largest absolute difference of any output
against the whole batch's at each chunk size (0 means bit-equal; NaN at
the same place on both sides counts as equal).
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rpe_tpu_torch import rng  # noqa: E402
from rpe_tpu_torch.config import EstimatorConfig, MatcherConfig, \
    RansacConfig  # noqa: E402
from rpe_tpu_torch.geometry import five_point as fp  # noqa: E402
from rpe_tpu_torch.geometry import homography as hom  # noqa: E402
from rpe_tpu_torch.geometry import ransac as rs  # noqa: E402
from rpe_tpu_torch.geometry.ambiguity import ambiguity_blend  # noqa: E402
from rpe_tpu_torch.geometry.eig import eigh3x3_desc, \
    smallest_eigvec_sym  # noqa: E402
from rpe_tpu_torch.geometry.epipolar import _build_epipolar_rows, \
    normal_matrix, normalize_points, project_to_essential, \
    sampson_error_sq  # noqa: E402
from rpe_tpu_torch.geometry.recover_pose import _four_candidates, \
    decompose_essential, recover_pose, triangulate_depths  # noqa: E402
from rpe_tpu_torch.ops import sift  # noqa: E402
from rpe_tpu_torch.pipeline.estimator import detect_features, \
    estimate_sequence_batched, match_features  # noqa: E402
from rpe_tpu_torch.utils.device import full_precision, \
    resolve_device  # noqa: E402

SIZES = (16, 8, 1)      # pairs a call, against all pairs in one call


def diff(a, b) -> float:
    """Largest |a - b|; equal values and NaN against NaN count 0."""
    a, b = a.double(), b.double()
    same = (a == b) | (torch.isnan(a) & torch.isnan(b))
    d = torch.where(same, 0.0, (a - b).abs())
    return float(torch.nan_to_num(d, nan=float("inf")).max()) \
        if d.numel() else 0.0


def _outputs(x):
    if isinstance(x, dict):
        return [x[k] for k in sorted(x)]
    if isinstance(x, (tuple, list)):
        return list(x)
    return [x]


def split_diff(fn, n: int, size: int, whole=None) -> float:
    """fn(slice of pairs) on all n pairs against its outputs on chunks of
    `size` pairs joined on the pair axis."""
    whole = _outputs(fn(slice(0, n)) if whole is None else whole)
    parts = [_outputs(fn(slice(a, min(a + size, n))))
             for a in range(0, n, size)]
    return max(diff(w, torch.cat([p[i] for p in parts]))
               for i, w in enumerate(whole))


def frame_chunks(n: int, size: int):
    """The frames of each chunk of `size` pairs out of n: a chunk of c
    pairs takes c + 1 frames."""
    return [slice(a, min(a + size, n) + 1) for a in range(0, n, size)]


def sift_detection_probe(imgs, cfg: EstimatorConfig, sizes=SIZES,
                         say=print):
    """SIFT's detection stage by stage (ops/sift.py): each stage runs on
    the whole run's inputs of each chunk's frames, every octave, and is
    compared with the whole run's outputs on those frames. Returns
    {stage: {size: largest difference}} and prints one line a stage."""
    n = imgs.shape[0] - 1
    sc = cfg.sift
    res = {}

    def record(name, whole, part_fn):
        """Fold one octave's differences of stage `name` into res."""
        got = res.setdefault(name, {c: 0.0 for c in sizes})
        whole = _outputs(whole)
        for c in sizes:
            for sl in frame_chunks(n, c):
                part = _outputs(part_fn(sl))
                got[c] = max([got[c]] + [diff(w[sl], p)
                                         for w, p in zip(whole, part)])

    def stage(name, fn):
        """Stage `name`: fn(frame slice) on the whole run and on each
        chunk's frames; returns the whole run's outputs."""
        whole = fn(slice(0, n + 1))
        record(name, whole, fn)
        return whole

    octaves = stage("scale space",
                    lambda sl: sift.scale_space(imgs[sl], sc.noctaves))
    quotas = sift.octave_quotas(sc.max_kpts, sc.noctaves)
    for o, G in enumerate(octaves):
        D = G[:, 1:] - G[:, :-1]
        ext = stage("extrema", lambda sl: sift.extrema_values(D[sl]))
        s0, flat = stage("select", lambda sl: sift.select_candidates(
            ext[sl], quotas[o]))
        xy, lay, scores, valid, kint = stage(
            "refine", lambda sl: sift.refine_candidates(D[sl], s0[sl],
                                                        flat[sl]))
        xy, scl, ucx, ucy, gxp, gyp = stage(
            "patches", lambda sl: sift.keypoint_patches(
                G[sl], xy[sl], lay[sl], valid[sl], kint[sl]))

        def orient(sl):
            return sift.orientation_hist(gxp[sl], gyp[sl], ucx[sl], ucy[sl],
                                         scl[sl], detail=True)

        hist, vx, vy, _ = orient(slice(0, n + 1))
        record("orient sample", (vx, vy), lambda sl: orient(sl)[1:3])
        record("orient hist", hist, lambda sl: orient(sl)[0])
        th1, th2, has2 = stage("theta", lambda sl: sift.orientation_peaks(
            hist[sl], valid[sl]))
        _, pidx, theta = stage("reselect", lambda sl: sift.reselect(
            scores[sl], valid[sl], th1[sl], th2[sl], has2[sl]))
        sx, sy, ss = (torch.gather(v, 1, pidx) for v in (ucx, ucy, scl))

        def describe(sl):
            return sift.descriptor(gxp[sl], gyp[sl], pidx[sl], sx[sl],
                                   sy[sl], ss[sl], theta[sl], detail=True)

        desc, dvx, dvy, raw = describe(slice(0, n + 1))
        record("desc sample", (dvx, dvy), lambda sl: describe(sl)[1:3])
        record("desc hist", raw, lambda sl: describe(sl)[3])
        record("desc", desc, lambda sl: describe(sl)[0])
        del G, D, ext, gxp, gyp, hist, vx, vy, desc, dvx, dvy, raw
    for name, r in res.items():
        say(f"{name:14s}" + "  ".join(f"{c:2d}/call {r[c]:.3g}"
                                      for c in sizes))
    return res


def run_probe(imgs, K, keys, cfg: EstimatorConfig, sizes=SIZES,
              say=print):
    """Every stage of the path at every chunk size in `sizes`; returns
    {stage: {size: largest difference}} and prints one line a stage."""
    n = keys.shape[0]
    res = {}

    def stage(name, fn, whole=None):
        if whole is None:
            whole = fn(slice(0, n))
        res[name] = {c: split_diff(fn, n, c, whole) for c in sizes}
        say(f"{name:14s}" + "  ".join(
            f"{c:2d}/call {res[name][c]:.3g}" for c in sizes))
        return whole

    def pick(d, s):
        return {k: v[s] for k, v in d.items()}

    with torch.no_grad():
        if cfg.feature_method.upper() == "SIFT":
            res.update(sift_detection_probe(imgs, cfg, sizes, say))
        dets = detect_features(imgs, cfg)
        d_det = {}
        for c in sizes:
            d_det[c] = 0.0
            for sl in frame_chunks(n, c):
                part = detect_features(imgs[sl], cfg)
                d_det[c] = max([d_det[c]] + [
                    diff(dets[k][sl], part[k]) for k in sorted(dets)])
        res["detect"] = d_det
        say(f"{'detect':14s}" + "  ".join(
            f"{c:2d}/call {d_det[c]:.3g}" for c in sizes))
        det1 = {k: v[:-1] for k, v in dets.items()}
        det2 = {k: v[1:] for k, v in dets.items()}

        m = stage("match", lambda s: match_features(pick(det1, s),
                                                    pick(det2, s), cfg))
        pts1 = torch.gather(det1["xy"], 1,
                            m["idx1"][..., None].expand(-1, -1, 2))
        pts2 = torch.gather(det2["xy"], 1,
                            m["idx2"][..., None].expand(-1, -1, 2))
        mv = m["valid"]
        n1, n2 = normalize_points(pts1, K), normalize_points(pts2, K)
        thr = (cfg.ransac.threshold_px / (0.5 * (K[0, 0] + K[1, 1]))
               ).expand(n).contiguous()
        thr2 = (thr * thr)[:, None, None]
        hyps = cfg.ransac.num_hypotheses
        if cfg.ransac.solver == "8pt":
            idx = rs.sample_minimal_indices(keys, mv, hyps)
            s1, s2 = rs.gather_points(n1, idx), rs.gather_points(n2, idx)
            AtA8 = stage("8pt AtA", lambda s: normal_matrix(
                _build_epipolar_rows(s1[s], s2[s])))
            stage("8pt eig", lambda s: smallest_eigvec_sym(AtA8[s]))
            E_h, hyp_ok = stage("hypotheses", lambda s: rs.hypotheses(
                keys[s], n1[s], n2[s], mv[s], hyps, "8pt"))
        else:
            idx = rs.sample_minimal_indices(keys, mv, hyps, sample_size=5)
            s1, s2 = rs.gather_points(n1, idx), rs.gather_points(n2, idx)

            stage("null4", lambda s: fp._householder_null4(
                _build_epipolar_rows(s1[s], s2[s])))
            null4, coeffs = stage(
                "coeffs", lambda s: fp.constraint_coeffs(s1[s], s2[s]))

            def roots(s):
                c = coeffs[s]
                out = fp.solve_roots_polished(
                    c.reshape(-1, 10, 20).contiguous())
                return tuple(o.reshape(*c.shape[:2], fp.MAX_ROOTS)
                             for o in out)

            rt = stage("roots", roots)
            E_r, has = stage("candidates", lambda s: fp._assemble_candidates(
                null4[s], *(o[s] for o in rt)))
            E_r = E_r.reshape(n, -1, 3, 3)
            hyp_ok = has.reshape(n, -1)
            E_h = stage("project", lambda s: project_to_essential(E_r[s]))[0]

        inl_h, counts, trunc = stage("score", lambda s: rs.score_hypotheses(
            E_h[s], hyp_ok[s], n1[s], n2[s], mv[s], thr2[s]))
        best, score = stage("winner", lambda s: rs.select_winner(
            E_h[s], inl_h[s], counts[s], trunc[s], n1[s], n2[s]))
        ar = torch.arange(n, device=imgs.device)
        E_best, mask = E_h[ar, best], inl_h[ar, best]
        rows = _build_epipolar_rows(n1, n2) * mask.to(n1.dtype)[..., None]
        AtA = stage("refit AtA", lambda s: normal_matrix(rows[s]))
        EtE = torch.matmul(E_best.transpose(-1, -2), E_best)
        stage("eig", lambda s: (smallest_eigvec_sym(AtA[s]),
                                *eigh3x3_desc(EtE[s])))
        stage("project refit", lambda s: project_to_essential(E_best[s]))
        thr2p = thr2[:, 0]
        stage("lo", lambda s: rs.local_optimization(
            keys[s], E_best[s], mask[s], n1[s], n2[s], mv[s], thr2p[s]))
        for r in range(cfg.ransac.refit_rounds):
            E_best, mask = stage(f"refit {r + 1}", lambda s: rs.refit_round(
                E_best[s], mask[s], n1[s], n2[s], mv[s], thr2p[s]))
        n_in = mask.sum(-1, dtype=torch.int32)

        key7 = rng.fold_in(keys, 7)
        kk = rng.split(key7)
        kH, kPP = kk[:, 0], kk[:, 1]
        idx4 = rs.sample_minimal_indices(kH, mask, 64, sample_size=4)
        dlt = hom._build_dlt_rows(rs.gather_points(n1, idx4),
                                  rs.gather_points(n2, idx4))
        stage("dlt AtA", lambda s: normal_matrix(dlt[s]))
        Hm = stage("homography", lambda s: hom.ransac_homography(
            kH[s], n1[s], n2[s], mask[s], thr[s], num_hypotheses=64))[0]
        sigma2 = (thr / 2.0) ** 2
        d2_E = sampson_error_sq(E_best, n1, n2)
        d2_E = torch.where(torch.isfinite(d2_E), d2_E, 16.0 * sigma2[:, None])
        stage("gric", lambda s: hom.gric_score(d2_E[s], mv[s], sigma2[s],
                                               d_dim=3.0, k_par=5.0))
        eh = hom.homography_transfer_err_sq(Hm, n1, n2)
        dh = torch.where(torch.isfinite(eh), torch.sqrt(eh), torch.inf)
        off = mv & (dh > 2.0 * thr[:, None])
        stage("parallax", lambda s: hom.plane_parallax_essentials(
            kPP[s], Hm[s], n1[s], n2[s], off[s], num_hypotheses=64))
        E_d, mask_d, n_d, used, _ = stage(
            "degensac", lambda s: hom.degensac_rescue(
                key7[s], E_best[s], mask[s], n_in[s], n1[s], n2[s], mv[s],
                thr[s]))

        top = torch.sort(score, dim=-1, descending=True, stable=True)[1][
            :, :16]
        arc = ar[:, None]
        w_top = inl_h[arc, top].to(n1.dtype)
        rows_top = _build_epipolar_rows(n1[:, None], n2[:, None]) \
            * w_top[..., None]
        stage("ambig AtA", lambda s: normal_matrix(rows_top[s]))
        E_bl, mask_bl, n_bl, _ = stage("ambiguity", lambda s: ambiguity_blend(
            E_h[s], score[s], counts[s], inl_h[s], n1[s], n2[s], mv[s],
            thr[s], E_d[s], mask_d[s], n_d[s]))
        E_f = torch.where(used[:, None, None], E_d, E_bl)
        mask_f = torch.where(used[:, None], mask_d, mask_bl)
        stage("decompose", lambda s: decompose_essential(E_f[s]))
        Rs, ts = _four_candidates(E_f)
        stage("triangulate", lambda s: triangulate_depths(
            Rs[s], ts[s], n1[s][:, None], n2[s][:, None]))
        stage("recover_pose", lambda s: recover_pose(
            E_f[s], n1[s], n2[s], mv[s], inlier_mask=mask_f[s]))

        def pose(s):
            o = estimate_sequence_batched(imgs[s.start:s.stop + 1], K,
                                          keys[s], cfg, device=imgs.device)
            return {k: o[k] for k in ("R", "t", "valid", "num_inliers",
                                      "num_matches")}

        stage("pose", pose)
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default)")
    ap.add_argument("--pairs", type=int, default=32)
    ap.add_argument("--feature", choices=("orb", "sift"), default="orb")
    ap.add_argument("--size", type=int, nargs=2, default=(376, 1241),
                    metavar=("H", "W"), help="frame size (default KITTI's)")
    ap.add_argument("--solver", choices=("5pt", "8pt"), default="5pt",
                    help="RansacConfig(solver=...) (default 5pt)")
    args = ap.parse_args()
    from rpe_tpu_torch.utils.synthetic import make_sequence

    dev = resolve_device(args.device)
    full_precision()
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(f"device: {smi.stdout.strip() or torch.cuda.get_device_name()}")
    else:
        print("device: cpu")
    cfg = EstimatorConfig(ransac=RansacConfig(solver=args.solver))
    if args.feature == "sift":
        cfg = dataclasses.replace(cfg, feature_method="SIFT",
                                  matcher=MatcherConfig(norm_type="l2"))
    n = args.pairs
    # chip_smoke.py phase 5's motion (SEQ_STEP, SEQ_ROT_DEG), seed 0
    frames, K, _ = make_sequence(n + 1, *args.size, seed=0,
                                 step=(0.035, -0.005, 0.1), rot_deg=0.25)
    imgs = torch.from_numpy(frames).to(dev)
    Kt = torch.as_tensor(K, dtype=torch.float32, device=dev)
    keys = torch.stack([rng.PRNGKey(i) for i in range(n)]).to(dev)
    print(f"{args.feature.upper()} ({args.solver}), {n} pairs: largest "
          f"difference against one call of {n} pairs")
    res = run_probe(imgs, Kt, keys, cfg, tuple(c for c in SIZES if c < n))
    moved = [k for k, v in res.items() if any(x != 0.0 for x in v.values())]
    print(f"stages that move: {moved or 'none'}")


if __name__ == "__main__":
    main()
