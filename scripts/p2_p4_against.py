#!/usr/bin/env python3
"""P2 (the geometry's fixed-order products, csrc/fixed_order.cu) and P4
(SIFT's descriptor, csrc/sift_sample.cu) against another version of the
port on the card: the elements whose bits differ, the poses of every
path, and the times of both in turns.

    python3 scripts/p2_p4_against.py --against ROOT   # ROOT holds another
                                                      # rpe_tpu_torch/

Needs a CUDA card and nvcc. ROOT's `rpe_tpu_torch` package (e.g. a `git
archive` of the parent commit's rpe_tpu_torch/ unpacked under .scratch/,
which .gitignore lists) is imported beside the repo's under another name
and builds its own kernels into its own csrc/build/. Inputs, made from
seed 0 as chip_smoke.py makes them (`make_sequence(9, 376, 1241)`, 8
pairs):

  - P2: every launch of one ORB call (EstimatorConfig()) of each version,
    recorded from its own call; each product or sum of the repo's
    launches also run through ROOT's wrappers (`fixed_order_bmm`,
    `fixed_order_sum`; a chain as two products). Printed: launches of
    each, products whose bits differ between them, and products of each
    that differ from the serial float64 reference (tests/torch_judges.py
    `p2_serial`);
  - P4: every octave's inputs of one SIFT A chunk's detection
    (`chip_smoke._record_sift`), through both versions' `descriptor` in
    detail mode: elements whose bits differ in the descriptors, the
    samples and the sums before normalising;
  - the paths of chip_smoke.py's phase 4 (`PATHS`) through both versions'
    `estimate_sequence_batched`: pairs whose R, t, valid, num_inliers or
    num_matches differ in any bit;
  - times in turns (ROOT, repo, repo, ROOT) by `kernel_breakdown.measure`
    (flushed, queued, host, device): P2 as each version's launches of one
    ORB call, P4 as the chunk's five; and the ORB and SIFT A calls end to
    end (host clock around a call and a synchronise, median of 5).
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
from rpe_tpu_torch.ops import kernels, sift  # noqa: E402
from rpe_tpu_torch.pipeline.estimator import detect_features, \
    estimate_sequence_batched  # noqa: E402
from rpe_tpu_torch.utils.device import full_precision  # noqa: E402
from rpe_tpu_torch.utils.synthetic import make_sequence  # noqa: E402

OTHER = "other_rpe_tpu_torch"
# chip_smoke.py phase 4's paths: (label, EstimatorConfig keywords as
# (matcher, ransac, feature) options, environment)
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
]
FIELDS = ("R", "t", "valid", "num_inliers", "num_matches")


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
    if opts.get("lo"):
        kw["ransac"] = cfg_mod.RansacConfig(lo=True)
    return cfg_mod.EstimatorConfig(**kw)


def record_one_product(torch, prods_mod, run):
    """The operands (a, b), b None for a row sum, of every launch that a
    version of P2 with one product a launch makes in run()."""
    ops = []
    bmm, rsum = prods_mod.fixed_order_bmm, prods_mod.fixed_order_sum

    def rec_bmm(a, b):
        ops.append((a.clone(), b.clone()))
        return bmm(a, b)

    def rec_sum(x):
        ops.append((x.clone(), None))
        return rsum(x)

    prods_mod.fixed_order_bmm, prods_mod.fixed_order_sum = rec_bmm, rec_sum
    try:
        with torch.no_grad():
            run()
    finally:
        prods_mod.fixed_order_bmm, prods_mod.fixed_order_sum = bmm, rsum
    return ops


def one_product_terms(prods_mod, terms):
    """A recorded group's products through a version with one product a
    launch (a chain as two)."""
    bmm, rsum = prods_mod.fixed_order_bmm, prods_mod.fixed_order_sum
    return [rsum(t[0]) if t[1] is None else bmm(t[0], t[1]) if len(t) == 2
            else bmm(t[0], bmm(t[1], t[2])) for t in terms]


def bits_differ(a, b):
    return int((a.contiguous().view(torch.int32)
                != b.contiguous().view(torch.int32)).sum())


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", metavar="ROOT", required=True,
                    help="directory holding the other rpe_tpu_torch/")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("p2_p4_against: needs a CUDA card")
    full_precision()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)
    other = load_other(args.against)
    o_kernels, o_prods, o_sift = (other(m) for m in (
        "ops.kernels", "geometry._products", "ops.sift"))
    o_cfg, o_est = other("config"), other("pipeline.estimator")
    kernels.build_all()
    o_kernels.build_all()
    for tag, log in (("repo", kernels.PTXAS_LOG), ("ROOT", o_kernels.PTXAS_LOG)):
        for key in ("fixed_order", "sift_sample"):
            for ln in log.get(key, "").splitlines():
                if "registers" in ln or "spill" in ln or "Compiling" in ln:
                    print(f"ptxas[{tag} {key}]: {ln.strip()}", flush=True)
    from torch_judges import p2_serial

    dev = torch.device("cuda")
    frames, K, _ = make_sequence(9, chip_smoke.H, chip_smoke.W, seed=0)
    keys = np.stack([np.array([0, i], np.uint32) for i in range(8)])
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)

    # P2: each version's launches of one ORB call
    launches, _ = chip_smoke._record_p2(torch, lambda: estimate_sequence_batched(
        frames, K, keys, EstimatorConfig(), device=dev))
    o_ops = record_one_product(torch, o_prods, lambda: o_est.
                               estimate_sequence_batched(
                                   frames, K, keys, o_cfg.EstimatorConfig(),
                                   device=dev))
    n_terms = differ = differ_elems = ser_mine = ser_theirs = 0
    for terms in launches:
        mine = prods.fixed_order_group(terms)
        old = one_product_terms(o_prods, terms)
        for t, a, b in zip(terms, mine, old):
            ref = p2_serial(t[0], t[1]) if len(t) == 2 else p2_serial(
                t[0], t[2], a2=t[1])
            n_terms += 1
            d = bits_differ(a, b)
            differ += int(d > 0)
            differ_elems += d
            ser_mine += int(not torch.equal(a, ref))
            ser_theirs += int(not torch.equal(b, ref))
    o_ser = sum(int(not torch.equal(
        o_prods.fixed_order_sum(a) if b is None else
        o_prods.fixed_order_bmm(a, b), p2_serial(a, b))) for a, b in o_ops)
    print(f"P2: one ORB call (8 pairs): repo {len(launches)} launches "
          f"({n_terms} products and sums), ROOT {len(o_ops)} launches; the "
          f"repo's products through ROOT's P2: {differ} differ "
          f"({differ_elems} elements); differing from the serial float64 "
          f"reference: repo {ser_mine}, ROOT {ser_theirs} (ROOT's own "
          f"launches: {o_ser} of {len(o_ops)})", flush=True)

    # P4: one SIFT A chunk's five launches
    cfg_a = EstimatorConfig(feature_method="SIFT",
                            matcher=MatcherConfig(norm_type="l2"))
    imgs = torch.from_numpy(frames).to(dev)
    _, desc_calls = chip_smoke._record_sift(
        torch, lambda: detect_features(imgs, cfg_a))
    for o, d in enumerate(desc_calls):
        mine = sift.descriptor(*d, detail=True)
        old = o_sift.descriptor(*d, detail=True)
        print(f"P4 octave {o} ({tuple(d[2].shape)} slots of "
              f"{tuple(d[0].shape[-2:])} patches): elements whose bits "
              f"differ: descriptor {bits_differ(mine[0], old[0])}, samples "
              f"{bits_differ(mine[1], old[1]) + bits_differ(mine[2], old[2])}"
              f", sums before normalising {bits_differ(mine[3], old[3])} "
              f"(of {mine[0].numel()} each)", flush=True)

    # the paths' poses
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
              f"{FIELDS}: {int(moved.sum())} of 8; valid {int(mine['valid'].sum())}",
              flush=True)

    # times in turns: ROOT, repo, repo, ROOT
    sets = {
        "P2 (one ORB call)": (
            lambda: [prods.fixed_order_group(t) for t in launches],
            lambda: [o_prods.fixed_order_sum(a) if b is None else
                     o_prods.fixed_order_bmm(a, b) for a, b in o_ops]),
        "P4 (one SIFT A chunk)": (
            lambda: [sift.descriptor(*d) for d in desc_calls],
            lambda: [o_sift.descriptor(*d) for d in desc_calls]),
    }
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
                  f"{smi.stdout.strip()})", flush=True)


if __name__ == "__main__":
    main()
