#!/usr/bin/env python3
"""The port's fixed-order kernels -- P1 (the 5-point coefficients,
csrc/five_point_coeffs.cu), P2 (the geometry's products,
csrc/fixed_order.cu), P3 and P4 (SIFT's orientation histogram and
descriptor, csrc/sift_sample.cu), P5-P8 (RANSAC's small solvers and the
threefry hash, csrc/small_solvers.cu) -- against another version of the
port on the card: the elements whose bits differ, the poses of every path,
and the times of both in turns.

    python3 scripts/fixed_order_against.py --against ROOT [--kernels P1 P3]
                                           # ROOT holds another
                                           # rpe_tpu_torch/

Needs a CUDA card and nvcc. ROOT's `rpe_tpu_torch` package (e.g. a `git
archive` of the parent commit's rpe_tpu_torch/ unpacked under .scratch/,
which .gitignore lists) is imported beside the repo's under another name
and builds its own kernels into its own csrc/build/. `--kernels` picks the
kernels to compare (default all four). Inputs, made from seed 0 as
chip_smoke.py makes them (`make_sequence(9, 376, 1241)`, 8 pairs):

  - P1: the main path's minimal samples (8 pairs x 256, from the ORB
    detections, `chip_smoke._main_path_samples`) and chip_smoke.py's 2048
    exact minimal problems, through both versions' `constraint_coeffs`:
    elements whose bits differ in null4 and in the coefficients;
  - P2: every launch of one ORB call (EstimatorConfig()) of each version,
    recorded from its own call (`fixed_order_group`: ROOT's P2 must take
    grouped launches, as from 6a8a235 on); each of the repo's launches
    also run through ROOT's.
    Printed: launches of each, products whose bits differ between them,
    and products of each that differ from the serial float64 reference
    (tests/torch_judges.py `p2_serial`);
  - P3 and P4: every octave's inputs of one SIFT A chunk's detection
    (`chip_smoke._record_sift`), through both versions in detail mode:
    elements whose bits differ in the histograms, samples and bins (P3),
    in the descriptors, samples and sums before normalising (P4); the
    repo's P3 histogram against `p3_serial` of its own samples and bins;
  - P5-P8: every call of one ORB call (EstimatorConfig()) to
    `smallest_eigvec_sym`, `eigh3x3_desc`, `threefry2x32` and
    `essential_frame` (P7 with the products and P6 around it), recorded
    from the repo's call, through the repo's functions and ROOT's of the
    same name (before P5-P8, ROOT's are the eager chains): elements whose
    bits differ, a NaN equal to a NaN;
  - the paths of chip_smoke.py's phase 4 (`PATHS`) through both versions'
    `estimate_sequence_batched`: pairs whose R, t, valid, num_inliers or
    num_matches differ in any bit;
  - times in turns (ROOT, repo, repo, ROOT) by `kernel_breakdown.measure`
    (flushed, queued, host, device): P1 as one launch on the main path's
    samples, P2 as each version's launches of one ORB call, P3 and P4 as
    the chunk's five, P5-P8 as the ORB call's calls of the four functions;
    and the ORB and SIFT A calls end to end (host clock
    around a call and a synchronise, median of 5).
"""

import argparse
import importlib
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke  # noqa: E402
from kernel_breakdown import measure  # noqa: E402
from rpe_tpu_torch.config import EstimatorConfig, \
    MatcherConfig  # noqa: E402
from rpe_tpu_torch.geometry import _products as prods  # noqa: E402
from rpe_tpu_torch.geometry import five_point as fp  # noqa: E402
from rpe_tpu_torch.ops import kernels, sift  # noqa: E402
from rpe_tpu_torch.pipeline.estimator import detect_features, \
    estimate_sequence_batched  # noqa: E402
from rpe_tpu_torch.utils.device import full_precision  # noqa: E402
from rpe_tpu_torch.utils.synthetic import make_sequence  # noqa: E402

OTHER = "other_rpe_tpu_torch"
KERNELS = ("P1", "P2", "P3", "P4", "P5-P8")
# chip_smoke.py phase 4's paths: (label, EstimatorConfig options, environment)
PATHS = [
    ("ORB cross-check", {}, {}),
    ("SIFT A (L2 cross-check)", {"feature": "SIFT", "norm": "l2"}, {}),
    ("SIFT B (L2 ratio)", {"feature": "SIFT", "norm": "l2",
                           "cross_check": False}, {}),
    ("ORB ratio", {"cross_check": False}, {}),
    ("ORB RPE_EXTRACT_T_V7=1", {}, {"RPE_EXTRACT_T_V7": "1"}),
    ("ORB RPE_EXTRACT_T_BRIEF=0", {}, {"RPE_EXTRACT_T_BRIEF": "0"}),
    ("ORB RPE_EXTRACT_T=0", {}, {"RPE_EXTRACT_T": "0"}),
    ("ORB RPE_EXTRACT_T=0 RPE_EXTRACT_MOMENTS=0", {},
     {"RPE_EXTRACT_T": "0", "RPE_EXTRACT_MOMENTS": "0"}),
    ("ORB RPE_NO_ATLAS=1", {}, {"RPE_NO_ATLAS": "1"}),
    ("ORB RPE_NO_FUSED_ATLAS=1", {}, {"RPE_NO_FUSED_ATLAS": "1"}),
    ("ORB RPE_BRIEF=cv2", {}, {"RPE_BRIEF": "cv2"}),
    ("ORB RPE_BRIEF=cv2 RPE_EXTRACT_T_V7=1", {},
     {"RPE_BRIEF": "cv2", "RPE_EXTRACT_T_V7": "1"}),
    ("ORB RPE_BRIEF_QUANT=1", {}, {"RPE_BRIEF_QUANT": "1"}),
    ("ORB RansacConfig(lo=True)", {"lo": True}, {}),
    ("ORB RansacConfig(solver='8pt')", {"solver": "8pt"}, {}),
    ("ORB profile orb2000", {"profile": "orb2000"}, {}),
    ("ORB profile orb1000", {"profile": "orb1000"}, {}),
]
FIELDS = ("R", "t", "valid", "num_inliers", "num_matches")
# the library of each kernel, for the ptxas lines
SOURCE = {"P1": "five_point_coeffs", "P2": "fixed_order",
          "P3": "sift_sample", "P4": "sift_sample",
          "P5-P8": "small_solvers"}
# P5-P8: the function each version is called through, by module
SMALL = {"smallest_eigvec_sym": "geometry.eig",
         "eigh3x3_desc": "geometry.eig",
         "essential_frame": "geometry.epipolar", "threefry2x32": "rng"}


def load_other(root):
    """ROOT/rpe_tpu_torch imported as the package OTHER (its modules
    import each other relatively, so they stay within it)."""
    pkg = Path(root) / "rpe_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        OTHER, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[OTHER] = mod
    spec.loader.exec_module(mod)
    return lambda name: importlib.import_module(f"{OTHER}.{name}")


def config(cfg_mod, opts):
    """An EstimatorConfig of the module `cfg_mod` for PATHS' options."""
    kw = {}
    if "feature" in opts:
        kw["feature_method"] = opts["feature"]
    if "norm" in opts or "cross_check" in opts:
        kw["matcher"] = cfg_mod.MatcherConfig(
            norm_type=opts.get("norm", "hamming"),
            cross_check=opts.get("cross_check", True))
    if opts.get("lo") or "solver" in opts:
        kw["ransac"] = cfg_mod.RansacConfig(lo=opts.get("lo", False),
                                            solver=opts.get("solver", "5pt"))
    if "profile" in opts:
        return cfg_mod.profile_config(opts["profile"])
    return cfg_mod.EstimatorConfig(**kw)


def bits_differ(a, b):
    if a.dtype == torch.uint8:
        return int((a != b).sum())
    return int((a.contiguous().view(torch.int32)
                != b.contiguous().view(torch.int32)).sum())


def compare_p1(o_fp, dets, K, dev):
    """P1 on the main path's samples and the 2048 exact problems through
    both versions. Returns the main path's samples."""
    s1, s2 = chip_smoke._main_path_samples(torch, dets, EstimatorConfig(),
                                           K, dev)
    exact = chip_smoke._exact_minimal_problems(np, torch, 2048, dev)
    for label, (p1, p2) in (("main path, 8 x 256 samples", (s1, s2)),
                            ("2048 exact problems", exact)):
        mine = fp.constraint_coeffs(p1, p2)
        old = o_fp.constraint_coeffs(p1, p2)
        print(f"P1 [{label}]: elements whose bits differ from ROOT's: "
              f"null4 {bits_differ(mine[0], old[0])} of {mine[0].numel()}, "
              f"coefficients {bits_differ(mine[1], old[1])} of "
              f"{mine[1].numel()}", flush=True)
    return s1, s2


def compare_p2(o_prods, o_cfg, o_est, frames, K, keys, dev):
    """Each version's P2 launches of one ORB call, and the repo's launches
    through ROOT's P2. Returns (the repo's recorded launches, ROOT's)."""
    launches, _ = chip_smoke._record_p2(torch, lambda: estimate_sequence_batched(
        frames, K, keys, EstimatorConfig(), device=dev))
    group = o_prods.fixed_order_group
    o_ops = []

    def rec(terms):
        o_ops.append([tuple(None if x is None else x.clone() for x in t)
                      for t in terms])
        return group(terms)

    o_prods.fixed_order_group = rec
    try:
        with torch.no_grad():
            o_est.estimate_sequence_batched(
                frames, K, keys, o_cfg.EstimatorConfig(), device=dev)
    finally:
        o_prods.fixed_order_group = group
    n_terms = differ = differ_elems = ser_mine = ser_theirs = 0
    for terms in launches:
        mine = prods.fixed_order_group(terms)
        old = group(terms)
        for t, a, b in zip(terms, mine, old):
            ref = chip_smoke._p2_serial(t)
            n_terms += 1
            d = bits_differ(a, b)
            differ += int(d > 0)
            differ_elems += d
            ser_mine += int(not torch.equal(a, ref))
            ser_theirs += int(not torch.equal(b, ref))
    print(f"P2: one ORB call (8 pairs): repo {len(launches)} launches "
          f"({n_terms} products and sums), ROOT {len(o_ops)} launches; the "
          f"repo's products through ROOT's P2: {differ} differ "
          f"({differ_elems} elements); differing from the serial float64 "
          f"reference: repo {ser_mine}, ROOT {ser_theirs}", flush=True)
    return launches, o_ops


def compare_sift(o_sift, ori_calls, desc_calls, which):
    """P3's and P4's detail outputs of both versions, octave by octave."""
    from torch_judges import p3_serial

    if "P3" in which:
        for o, a in enumerate(ori_calls):
            mine = sift.orientation_hist(*a, detail=True)
            old = o_sift.orientation_hist(*a, detail=True)
            serial = bits_differ(mine[0], p3_serial(*mine[1:]))
            print(f"P3 octave {o} ({tuple(a[0].shape[:2])} slots of "
                  f"{tuple(a[0].shape[-2:])} patches): elements whose bits "
                  f"differ from ROOT's: histogram "
                  f"{bits_differ(mine[0], old[0])} of {mine[0].numel()}, "
                  f"samples {bits_differ(mine[1], old[1]) + bits_differ(mine[2], old[2])}"
                  f" of {2 * mine[1].numel()}, bins "
                  f"{bits_differ(mine[3], old[3])} of {mine[3].numel()}; "
                  f"histogram against p3_serial of its own samples: {serial}",
                  flush=True)
    if "P4" in which:
        for o, d in enumerate(desc_calls):
            mine = sift.descriptor(*d, detail=True)
            old = o_sift.descriptor(*d, detail=True)
            print(f"P4 octave {o} ({tuple(d[2].shape)} slots of "
                  f"{tuple(d[0].shape[-2:])} patches): elements whose bits "
                  f"differ: descriptor {bits_differ(mine[0], old[0])}, "
                  f"samples {bits_differ(mine[1], old[1]) + bits_differ(mine[2], old[2])}"
                  f", sums before normalising {bits_differ(mine[3], old[3])} "
                  f"(of {mine[0].numel()} each)", flush=True)


def compare_small(other, frames, K, keys, dev):
    """P5-P8: the calls of one ORB call through both versions' functions;
    returns (the repo's, ROOT's) runs of all of them, for the times."""
    from rpe_tpu_torch.geometry import epipolar, recover_pose

    es = []
    ef = epipolar.essential_frame

    def rec(E):
        es.append((E.clone(),))
        return ef(E)

    epipolar.essential_frame = recover_pose.essential_frame = rec
    try:
        calls = chip_smoke._record_small(torch, lambda: (
            estimate_sequence_batched(frames, K, keys, EstimatorConfig(),
                                      device=dev)))
    finally:
        epipolar.essential_frame = recover_pose.essential_frame = ef
    calls["essential_frame"] = es
    runs = []
    for name, module in SMALL.items():
        mine = getattr(importlib.import_module(f"rpe_tpu_torch.{module}"),
                       name)
        old = getattr(other(module), name)
        moved = total = 0
        for a in calls[name]:
            m, o = mine(*a), old(*a)
            for x, y in zip(m if isinstance(m, tuple) else (m,),
                            o if isinstance(o, tuple) else (o,)):
                same = ((x == y) | (torch.isnan(x) & torch.isnan(y))
                        if x.is_floating_point() else x == y)
                moved += int((~same).sum())
                total += x.numel()
        print(f"P5-P8 [{name}]: {len(calls[name])} calls, elements whose "
              f"bits differ from ROOT's: {moved} of {total}", flush=True)
        runs.append((mine, old, calls[name]))
    return (lambda: [f(*a) for f, _, c in runs for a in c],
            lambda: [f(*a) for _, f, c in runs for a in c])


def compare_paths(o_cfg, o_est, frames, K, keys, dev):
    """Every phase 4 path through both versions: pairs that differ."""
    for label, opts, gates in PATHS:
        with chip_smoke._gates(gates):
            mine = estimate_sequence_batched(
                frames, K, keys, config(sys.modules[
                    "rpe_tpu_torch.config"], opts), device=dev)
            old = o_est.estimate_sequence_batched(
                frames, K, keys, config(o_cfg, opts), device=dev)
        moved = torch.zeros(8, dtype=torch.bool, device=dev)
        for f in FIELDS:
            a, b = mine[f], old[f]
            same = (a == b) | (torch.isnan(a) & torch.isnan(b)) \
                if a.is_floating_point() else a == b
            moved |= ~same.reshape(8, -1).all(-1)
        print(f"poses [{label}]: pairs differing from ROOT's in any bit of "
              f"{FIELDS}: {int(moved.sum())} of 8; valid "
              f"{int(mine['valid'].sum())}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", metavar="ROOT", required=True,
                    help="directory holding the other rpe_tpu_torch/")
    ap.add_argument("--kernels", nargs="+", choices=KERNELS,
                    default=list(KERNELS), help="kernels to compare")
    args = ap.parse_args()
    which = set(args.kernels)
    if not torch.cuda.is_available():
        sys.exit("fixed_order_against: needs a CUDA card")
    full_precision()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    print(f"nvidia-smi: {card}", flush=True)
    other = load_other(args.against)
    o_kernels, o_prods, o_sift, o_fp = (other(m) for m in (
        "ops.kernels", "geometry._products", "ops.sift",
        "geometry.five_point"))
    o_cfg, o_est = other("config"), other("pipeline.estimator")
    kernels.build_all()
    o_kernels.build_all()
    for tag, log in (("repo", kernels.PTXAS_LOG),
                     ("ROOT", o_kernels.PTXAS_LOG)):
        for key in sorted({SOURCE[k] for k in which}):
            for ln in log.get(key, "").splitlines():
                if "registers" in ln or "spill" in ln or "Compiling" in ln:
                    print(f"ptxas[{tag} {key}]: {ln.strip()}", flush=True)

    dev = torch.device("cuda")
    frames, K, _ = make_sequence(9, chip_smoke.H, chip_smoke.W, seed=0)
    keys = np.stack([np.array([0, i], np.uint32) for i in range(8)])
    imgs = torch.from_numpy(frames).to(dev)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)
    sets = {}

    if "P1" in which:
        with torch.no_grad():
            dets = detect_features(imgs, EstimatorConfig())
            s1, s2 = compare_p1(o_fp, dets, K, dev)
        sets["P1 (the main path's 2048 samples)"] = (
            lambda: fp.constraint_coeffs(s1, s2),
            lambda: o_fp.constraint_coeffs(s1, s2))
        del dets
    if "P2" in which:
        launches, o_ops = compare_p2(o_prods, o_cfg, o_est, frames, K, keys,
                                     dev)
        sets["P2 (one ORB call)"] = (
            lambda: [prods.fixed_order_group(t) for t in launches],
            lambda: [o_prods.fixed_order_group(t) for t in o_ops])
    if which & {"P3", "P4"}:
        cfg_a = EstimatorConfig(feature_method="SIFT",
                                matcher=MatcherConfig(norm_type="l2"))
        ori_calls, desc_calls = chip_smoke._record_sift(
            torch, lambda: detect_features(imgs, cfg_a))
        compare_sift(o_sift, ori_calls, desc_calls, which)
        if "P3" in which:
            sets["P3 (one SIFT A chunk)"] = (
                lambda: [sift.orientation_hist(*a) for a in ori_calls],
                lambda: [o_sift.orientation_hist(*a) for a in ori_calls])
        if "P4" in which:
            sets["P4 (one SIFT A chunk)"] = (
                lambda: [sift.descriptor(*d) for d in desc_calls],
                lambda: [o_sift.descriptor(*d) for d in desc_calls])

    if "P5-P8" in which:
        sets["P5-P8 (one ORB call)"] = compare_small(other, frames, K, keys,
                                                     dev)

    compare_paths(o_cfg, o_est, frames, K, keys, dev)

    # times in turns: ROOT, repo, repo, ROOT
    for name, (repo_fn, root_fn) in sets.items():
        for tag, fn in (("ROOT", root_fn), ("repo", repo_fn),
                        ("repo", repo_fn), ("ROOT", root_fn)):
            measure(f"{name} [{tag}]", fn, flush)
    for label, opts in (("ORB", {}), ("SIFT A", {"feature": "SIFT",
                                                 "norm": "l2"})):
        runs = {"repo": (estimate_sequence_batched, config(
            sys.modules["rpe_tpu_torch.config"], opts)),
            "ROOT": (o_est.estimate_sequence_batched, config(o_cfg, opts))}
        for tag in ("ROOT", "repo", "repo", "ROOT"):
            fn, cfg = runs[tag]
            fn(frames, K, keys, cfg, device=dev)
            torch.cuda.synchronize()
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn(frames, K, keys, cfg, device=dev)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            print(f"{label} call [{tag}]: median {np.median(times) * 1e3:.1f} "
                  f"ms, {8 / np.median(times):.3f} pairs/s (8 pairs, "
                  f"{card})", flush=True)


if __name__ == "__main__":
    main()
