"""Every pair of every chunk of a pool, over many seeds: the program's
inlier count against the scene's ground-truth inliers (the reference's
Sampson test at the configuration's threshold), the pose layer's
`inlier_short` without the check's sampling.

    python3 posebench/scan.py --config orb4000 --traffic kitti_b32 \
        --seed 2147494000 --seeds 25 [--degensac off]

runs on the card (or the CPU without one) and prints one JSON line per
seed (the worst share short and the pairs short by more than 0.05: chunk,
pair, share, rotation error in degrees) and a last line of totals. With
`--degensac off` it runs the program's other path, DEGENSAC off. The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def scan_seed(config: dict, traffic: dict, seed: int, device,
              degensac: bool | None = None) -> list[tuple]:
    """(chunk, pair, truth inliers, inliers, share short, rotation error)
    of every pair of the seed's pool."""
    import torch

    import harness
    import scene
    from reference import pose
    from rpe_tpu_torch.convert import keys_from_numpy
    from rpe_tpu_torch.pipeline import estimator as est

    cfg = harness.estimator_config(config["estimator"])
    if degensac is not None:
        cfg = dataclasses.replace(cfg, ransac=dataclasses.replace(
            cfg.ransac, degensac=degensac))
    dev = torch.device(device)
    pool = scene.Pool(traffic, seed, dev)
    K = torch.as_tensor(pool.K, dtype=torch.float64, device=dev)
    thr = (config["estimator"]["ransac"]["threshold_px"]
           / (0.5 * float(K[0, 0] + K[1, 1])))
    rows = []
    for c in range(len(pool)):
        out = est.estimate_sequence_batched(
            pool.frames[c], K.float(), keys_from_numpy(pool.keys[c],
                                                       device=dev), cfg, dev)
        Rg, tg = (torch.as_tensor(x, dtype=torch.float64, device=dev)
                  for x in pool.truth[c])
        E = pose.skew(tg) @ Rg
        for p in range(pool.pairs):
            mv = out["match_valid"][p].bool()
            d2 = pose.sampson_sq(E, pose.normalize(out["pts1"][p].double(), K),
                                 pose.normalize(out["pts2"][p].double(), K))
            nt = int(((d2 < thr * thr) & mv).sum())
            ni = int(out["num_inliers"][p])
            rows.append((c, p, nt, ni, (nt - ni) / max(nt, 1),
                         pose.rotation_error_deg(out["R"][p].cpu(),
                                                 Rg.cpu())))
    return rows


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=1)
    p.add_argument("--degensac", choices=("as-configured", "off"),
                   default="as-configured")
    args = p.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT))
    import torch

    config = json.loads((HERE / "configs" / f"{args.config}.json")
                        .read_text())
    traffic = json.loads((HERE / "traffic" / f"{args.traffic}.json")
                         .read_text())
    if device is None:
        device = "cuda:0" if torch.cuda.is_available() else "cpu"
    dg = None if args.degensac == "as-configured" else False
    pairs = short = 0
    for seed in range(args.seed, args.seed + args.seeds):
        rows = scan_seed(config, traffic, seed, device, dg)
        bad = [(c, q, round(s, 4), round(r, 4))
               for c, q, _, _, s, r in rows if s > 0.05]
        pairs += len(rows)
        short += len(bad)
        print(json.dumps({"seed": seed, "worst": max(r[4] for r in rows),
                          "short": bad}), flush=True)
    print(json.dumps({"config": args.config, "traffic": args.traffic,
                      "degensac": args.degensac, "pairs": pairs,
                      "short_over_0.05": short}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
