#!/usr/bin/env python3
"""Does a pair's pose depend on the batch it is estimated in?

A mesh of two shards estimates a chunk of 16 consecutive pairs as two
calls of 8. This script runs the ORB path (`EstimatorConfig()`) on one
1241x376 sequence of 17 frames both ways and compares each stage, so that
a difference is traced to the first stage whose output depends on the
batch:

  detect       detections of the 17 frames (9 + 9 with one shared frame)
  match        cross-check matches of each pair, on identical detections
  coeffs       the 5-point constraint coefficients (K4's input), on
               identical matches and keys
  roots        K4's roots on identical coefficients (one batch of 16 pairs
               against two of 8)
  ransac       `ransac_essential` on identical points, keys and masks
  pose         `estimate_sequence_batched` end to end

    python3 scripts/batch_invariance_probe.py              # on the card
    python3 scripts/batch_invariance_probe.py --device cpu

Prints one line per stage: the largest absolute difference, and for the
pose stage which pairs differ by more than 1e-5 in R.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rpe_tpu_torch import rng  # noqa: E402
from rpe_tpu_torch.config import EstimatorConfig  # noqa: E402
from rpe_tpu_torch.geometry import five_point as fp  # noqa: E402
from rpe_tpu_torch.geometry.epipolar import normalize_points  # noqa: E402
from rpe_tpu_torch.geometry.ransac import gather_points, \
    ransac_essential, sample_minimal_indices  # noqa: E402
from rpe_tpu_torch.pipeline.estimator import detect_features, \
    estimate_sequence_batched, match_features  # noqa: E402
from rpe_tpu_torch.utils.device import full_precision, \
    resolve_device  # noqa: E402
from rpe_tpu_torch.utils.synthetic import make_sequence  # noqa: E402


def diff(a, b) -> float:
    a, b = a.float() if a.dtype == torch.bool else a, \
        b.float() if b.dtype == torch.bool else b
    return float((a.double() - b.double()).abs().max())


def halves(fn, n_pairs):
    """fn(slice of pairs) over the whole batch, and over its two halves
    joined on the pair axis."""
    h = n_pairs // 2
    whole = fn(slice(0, n_pairs))
    a, b = fn(slice(0, h)), fn(slice(h, n_pairs))
    if isinstance(whole, dict):
        return whole, {k: torch.cat([a[k], b[k]]) for k in whole}
    if isinstance(whole, tuple):
        return whole, tuple(torch.cat([x, y]) for x, y in zip(a, b))
    return whole, torch.cat([a, b])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default)")
    ap.add_argument("--pairs", type=int, default=16)
    args = ap.parse_args()
    dev = resolve_device(args.device)
    full_precision()
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        print(f"device: {smi.stdout.strip() or torch.cuda.get_device_name()}")
    else:
        print("device: cpu")
    cfg = EstimatorConfig()
    n = args.pairs
    # chip_smoke.py phase 5's motion (SEQ_STEP, SEQ_ROT_DEG), seed 0
    frames, K, _ = make_sequence(n + 1, 376, 1241, seed=0,
                                 step=(0.035, -0.005, 0.1), rot_deg=0.25)
    imgs = torch.from_numpy(frames).to(dev)
    Kt = torch.as_tensor(K, dtype=torch.float32, device=dev)
    keys = torch.stack([rng.PRNGKey(i) for i in range(n)]).to(dev)

    with torch.no_grad():
        # detect: all frames at once against the halves' frames
        whole = detect_features(imgs, cfg)
        h = n // 2
        a, b = detect_features(imgs[:h + 1], cfg), detect_features(
            imgs[h:], cfg)
        print("detect  " + ", ".join(
            f"{k} {diff(whole[k], torch.cat([a[k], b[k][1:]])):.3g}"
            for k in ("xy", "bits", "valid")))
        det1 = {k: v[:-1] for k, v in whole.items()}
        det2 = {k: v[1:] for k, v in whole.items()}

        def pick(d, s):
            return {k: v[s] for k, v in d.items()}

        m16, m8 = halves(lambda s: match_features(pick(det1, s),
                                                  pick(det2, s), cfg), n)
        print("match   " + ", ".join(f"{k} {diff(m16[k], m8[k]):.3g}"
                                     for k in ("idx1", "idx2", "valid")))
        pts1 = torch.gather(det1["xy"], 1,
                            m16["idx1"][..., None].expand(-1, -1, 2))
        pts2 = torch.gather(det2["xy"], 1,
                            m16["idx2"][..., None].expand(-1, -1, 2))
        mvalid = m16["valid"]
        n1, n2 = normalize_points(pts1, Kt), normalize_points(pts2, Kt)
        thr = cfg.ransac.threshold_px / (0.5 * (Kt[0, 0] + Kt[1, 1]))
        H = cfg.ransac.num_hypotheses

        def coeffs(s):
            idx = sample_minimal_indices(keys[s], mvalid[s], H, 5)
            return fp.constraint_coeffs(gather_points(n1[s], idx),
                                        gather_points(n2[s], idx))

        (nw, cw), (nh, ch) = halves(coeffs, n)
        print(f"coeffs  null4 {diff(nw, nh):.3g}, coeffs {diff(cw, ch):.3g}")
        flat = cw.reshape(-1, 10, 20).contiguous()
        rw = fp.solve_roots_polished(flat)
        per = flat.shape[0] // 2
        rh = [torch.cat([x, y]) for x, y in zip(
            fp.solve_roots_polished(flat[:per].contiguous()),
            fp.solve_roots_polished(flat[per:].contiguous()))]
        print("roots   " + ", ".join(
            f"{k} {diff(x, y):.3g}" for k, x, y in zip(
                ("x", "y", "r", "flip", "has_root"), rw, rh)))

        def ransac(s):
            r = ransac_essential(
                keys[s], n1[s], n2[s], mvalid[s], thr.expand(n)[s],
                num_hypotheses=H, refit_rounds=cfg.ransac.refit_rounds,
                solver=cfg.ransac.solver, degensac=cfg.ransac.degensac)
            return r["E"], r["num_inliers"]

        (Ew, iw), (Eh, ih) = halves(ransac, n)
        sign = torch.sign((Ew * Eh).sum((-1, -2)))[:, None, None]
        print(f"ransac  E {diff(Ew, sign * Eh):.3g}, inliers "
              f"{diff(iw, ih):.3g}")

        ow = estimate_sequence_batched(imgs, Kt, keys, cfg, device=dev)
        oa = estimate_sequence_batched(imgs[:h + 1], Kt, keys[:h], cfg,
                                       device=dev)
        ob = estimate_sequence_batched(imgs[h:], Kt, keys[h:], cfg,
                                       device=dev)
        dR = (ow["R"] - torch.cat([oa["R"], ob["R"]])).abs().amax((1, 2))
        moved = [int(i) for i in torch.nonzero(dR > 1e-5)[:, 0]]
        dv = diff(ow["valid"], torch.cat([oa["valid"], ob["valid"]]))
        print(f"pose    R {float(dR.max()):.3g}; pairs over 1e-5: {moved}; "
              f"valid {dv:.3g}")


if __name__ == "__main__":
    main()
