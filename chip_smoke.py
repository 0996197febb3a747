#!/usr/bin/env python3
"""Drive the rpe_tpu_torch port on one CUDA card and hold its kernels to
their plain PyTorch versions.

    python3 chip_smoke.py            # needs one CUDA card, nvcc and the repo
    python3 chip_smoke.py --profile  # also pairs/s (ORB at B = 8 and 32,
                                     # SIFT A and B at B = 8) and a
                                     # torch.profiler table per config in
                                     # the output directory (OUT_DIR)

Phases (any failure exits non-zero before the final line):
  1. card: `nvidia-smi` name and power limit, torch and CUDA versions;
  2. build: every CUDA source of rpe_tpu_torch/csrc with nvcc (sm_90a),
     printing the ptxas resource lines;
  3. kernels: on a synthetic 1241x376 sequence (9 frames, made from a seed),
     each kernel against its plain version at the shapes one chunk of the
     main paths gives it -- K1 on the 9 frames' (3200, 1280) atlases (bit
     for bit: the interior against the plain version, the whole image
     against the plain version on the wrap-padded atlas), K2,
     K12 (binned BRIEF) and the patch kernels K8, K9, K10 on their real
     (100, 72) band tables, K3 and K6 (Hamming) on the 8 pairs' 4096 x 4096
     ORB descriptors, K7 and K6 (L2) on the 8 pairs' 4096 x 4096 x 128 SIFT
     descriptors, K4 on 8 x 256 hypotheses' coefficients and 2048 exact
     minimal problems, K5 (K4's brackets alone) on the latter -- with its
     contract, its time (CUDA events, L2 flushed before each launch; for
     K1, K2, K4, K5, K8-K10 and K12 also the queued time per call of 20
     calls back to back), the plain version's time, a library call's time where one
     computes the same function, and its bound on the H100; then K8, K9
     and K10 on edge-slot tables (live, parked, constant-raw and past-edge
     slots, one layout with F * NB * CAP not a multiple of 4) against their
     plain versions, K9's and K10's moments equal to K2's; K1 on the
     per-level path's inputs, levels 0 (376x1241) and 11 (132x435) of the
     9 frames' pyramids, held as on the atlas; K2 and K12 in the modes of
     RPE_BRIEF=cv2 with rounded samples, and K2 with rounded samples
     alone, against their plain versions in the same mode on the real
     tables (bits >= 0.999, moments as K2's), each with its time and
     bound (chip_smoke.json "modes"); the port's fixed-order kernels: P1
     (the 5-point constraint coefficients) on the 8 pairs x 256 samples
     (within 1e-5 of its plain version, no further from a float64 run
     than the plain float32 one + 1e-6, bit-equal split in two calls) and
     P2 on every launch it makes in one ORB call (each product bit-equal
     to tests/torch_judges.py `p2_serial`, the serial float64 loop over k;
     within 1e-6 of sum |a| |b| of torch.matmul / .sum; bit-equal split in
     two), each timed with its bound, P2 beside torch.matmul / .sum, P2
     and P4 with their times before the redesign; P3 (SIFT's
     orientation histogram) and P4 (its descriptor) on every octave's
     inputs of one SIFT A chunk's detection (tests/torch_judges.py
     `p3_judge`: each bin within 1e-6 of its terms' magnitudes of the plain
     version and of a float64 run, slots where a sample's bin differs
     from the plain version's counted and capped at 1 per 1000, and held
     within the moved samples' magnitudes; and bit-equal to
     `p3_serial` of its own samples and bins; `p4_judge`: within 1e-5 of
     both on every slot), each bit-equal with its frames and with its
     slots split in two, timed per chunk (5 launches) with its bound;
  4. paths: `estimate_sequence_batched` on the 9 frames (8 pairs) at
     EstimatorConfig() (ORB, Hamming cross-check: K1-K4), SIFT with L2
     cross-check (config A: K7, K4, P3 and P4 once per octave), SIFT with
     the L2 Lowe ratio test (config B: K6-L2, K4, P3, P4), and ORB with
     the Hamming ratio test (K1, K2,
     K6-Hamming, K4), then the ORB path under four of the reference's
     extraction gate settings, each taking K12, K10, K9 or K8 in K2's place
     (set in the process for that path, restored after it), then the ORB
     path under the reference's other switches: RPE_NO_ATLAS=1 (K1 once
     per level, 12 launches, K3, K4, no extraction kernel),
     RPE_NO_FUSED_ATLAS=1, RPE_BRIEF=cv2 (K2 in its wide, rounded mode),
     RPE_BRIEF=cv2 with RPE_EXTRACT_T_V7=1 (K12), RPE_BRIEF_QUANT=1 and
     RansacConfig(lo=True), then RansacConfig(solver="8pt") (K1-K3 and P2:
     no K4, no P1) and the ORB profiles orb2000 and orb1000
     (`config.profile_config`). Every launch counter is reset just before
     each path and read just after; each path must launch exactly its
     kernels, each as often as stated (once unless counted). Each path runs its first 3 frames
     again with device="cpu" (plain versions), which must agree (equal
     `valid`, <= 0.5 deg rotation); the K8-K10 routes' ORB bits must agree
     with the default route's on the same keypoints (>= 0.999); rotation
     error against the scene's ground truth; pairs/s; then one host line:
     the calibration tool (`tools.calibrate.calibrate_with_filtering`,
     numpy) on 12 seeded synthetic chessboard views, two corrupted, with
     its RMS;
  5. sequence runner: a synthetic 1241x376 sequence of 33 frames written as
     8-bit PNGs with a KITTI poses.txt and calib.txt (utils/synthetic.py
     `write_kitti_sequence`), run through `rpe_tpu_torch.cli.
     run_kitti_sequence.main` on the card at EstimatorConfig() in chunks of
     16 pairs with a checkpoint: K1-K4 launched once per chunk and nothing
     else, every frame decoded natively, every pair valid, rotation error
     against the scene and ATE/RPE against poses.txt under the limits below,
     pairs/s and the decode time per chunk; the same runner with
     device="cpu" on frames 0-3 (equal `valid`, <= 0.5 deg); a resume from
     the checkpoint (no launch, identical outputs); the inlier-collapse
     fallback on the card (tests/test_fallback.py's starved config, every
     pair re-run at orb512 by `estimate_pairs_batched`, adopted pairs
     holding more inliers); when the card finished each chunk against the
     host's decode of the next (CUDA events on the host's clock); and one
     torch.profiler trace of the runner's pair loop (device busy share);
  6. VP (Manhattan) refinement and the dataset runners: a synthetic
     1241x376 Manhattan room of 17 frames (utils/synthetic.py
     `manhattan_sequence` at `GATED_ROOM`, drawn through the runner's
     default intrinsics, the camera turning 0.25 deg a frame) written as
     PNGs in the simulator layout, run through `rpe_tpu_torch.cli.
     run_simulator_data.main` on the card at its defaults (VP on, the host
     twin, chunk 16): K1-K4 once per chunk and nothing else, every pair
     valid, the default VP gates passing on every frame, rotation error
     against the scene under VP_ROT_GT_DEG, the CSV and the plot written;
     the same with RPE_VP_DEVICE=1 (set for the run, restored after): the
     same per-frame gate decisions as the host twin's; frames 0-3 through
     the same runner with device="cpu" (equal `valid`, gate decisions and
     `vp_used`, <= 0.5 deg) and the share of pixels whose labels differ
     between the card and the CPU; `run_single_pair.main` on two of the
     PNGs; `PoseEstimator.estimate_with_debug` with R_prev on the card
     against the CPU (equal `vp_used` and VP statistics, the refined R no
     further apart than the plain poses + 1e-4 rad) and
     `refine_rotation_with_vps` from one start on both (R within 1e-4
     rad); the labeling of
     one block of 8 frames, the host segments and voting, and the device
     twin per block (CUDA events or the host clock after a synchronise),
     the labeling's device launches (torch.profiler), and pairs/s with VP;
  7. multi-device (rpe_tpu_torch/parallel) on meshes of the one card,
     each against the same work without a mesh: (a) the KITTI runner of
     phase 5 with `--devices 1` (`make_mesh(1)`): K1-K4 once per chunk,
     per-pair R within 1e-5 of phase 5's, `valid` equal, the same ATE;
     (b) `BatchProcessor` on phase 5's PNGs with the card listed twice
     ([cuda:0, cuda:0]): K1-K4 and P1 once per shard per chunk, and the
     mesh and chunk 8 without a mesh each held to chunk 16 without a mesh
     as tests/test_sharding.py:182-187 holds the reference (`valid` and
     `num_inliers` equal, R within 1e-5, t within 1e-4; the largest |dR|
     and |dt| printed), pairs/s of each beside phase 5's; (c)
     `estimate_sequence_sharded` on that mesh over phase 4's 9 frames
     equal to `estimate_sequence_batched` (R within 1e-5, t 1e-4);
     (d) `estimate_pairs_2d` on a (1, 2) mesh of the card for phase 4's 8
     pairs (detection and matching once, K4 once per hyp shard): `valid`
     equal to `estimate_pair`'s and R within 1 deg, pairs 0-1 also on a
     (1, 2) CPU mesh (equal `valid`, <= 0.5 deg); (e)
     `sharded_error_stats` over a one-process NCCL group started by
     `initialize_distributed` on a loopback address, on the card's global
     mesh and on [cuda:0, cuda:0], equal to numpy's statistics; the group
     is destroyed after;
  8. batch invariance: the ORB path (`estimate_sequence_batched`), the
     same with the 8-point solver and the orb2000 profile on phase 5's 33
     frames at 32 pairs in one call, 16 + 16, 8 x 4 and 1 x 32: R, t,
     `valid`, `num_inliers` and `num_matches` bit-equal, each split
     launching K1-K4 and P1 once per call (the 8-point solver K1-K3); the
     KITTI runner on
     phase 5's PNGs at --chunk 32 against phase 5's --chunk 16: per-pair R,
     `valid` and the ATE equal; SIFT A on the same frames at the same
     splits (detections and poses bit-equal, K7, K4, P1 once per call, P3
     and P4 once per octave per call) and SIFT B at 32 against 8 x 4; the
     simulator runner with --feature SIFT on phase 6's room at --chunk 16
     and --chunk 8: per-pair R and `valid` equal, K7, K4, P1-P4 per chunk.
Every path's launch gate counts P1 once and P2 `P2_PER_CALL` times per
estimator call (`P2_PER_CALL_LO` under LO-RANSAC; the 8-point solver no
P1 and `P2_PER_CALL_8PT`), P5-P8 as `SMALL_SOLVERS_PER_CALL` states for
the path, and a SIFT path P3 and
P4 once per octave of its frames (`geometry_launches`, `sift_launches`;
rpe_tpu_torch/ops/kernels.py).
The line before the last is the kernel JSON; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
OUT_DIR = HERE / "chiprun_out"
H, W = 376, 1241           # KITTI frames, the parity configuration's size

# H100 SXM peaks (NVIDIA data sheet, dense): memory and the rates used for
# each kernel's operation bound
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12          # CUDA-core float32
TF32X3_TC_OPS_PER_S = 494.7e12 / 3  # TF32 tensor cores, three products per
                                    # float32 product (K7, K6-L2)
INT8_TC_OPS_PER_S = 1979e12     # int8 tensor cores (K3's work as a GEMM)

# Phase 5's sequence: 33 frames, so 32 pairs in two chunks of 16. The motion
# is short enough that frame 32 still sees all three planes of the scene
# (the nearest is at Z = 9; make_sequence's default moves ~1 unit and turns
# 1.5 deg a frame). Poses are in units of one frame's step.
SEQ_FRAMES, SEQ_CHUNK = 33, 16
SEQ_STEP, SEQ_ROT_DEG = (0.035, -0.005, 0.1), 0.25
# Limits of phase 5, about twice what the first card run measured (NVIDIA
# H100 80GB HBM3, 700 W: max 0.3546 deg, ATE 0.1684, RPE 0.1607 and 0.0579
# deg; PERF.md, Findings, the KITTI runner):
SEQ_ROT_GT_DEG = 0.75       # max rotation error of a pair vs the scene
SEQ_ATE_SIM3 = 0.35         # ATE RMSE after sim3 alignment, in steps
SEQ_RPE_TRANS = 0.35        # RPE (delta 1) translation RMSE, in steps
SEQ_RPE_ROT_DEG = 0.12      # RPE (delta 1) rotation RMSE
# Phase 6's Manhattan room: 17 frames, one chunk of 16 pairs. The VP
# refinement replaces a pair's rotation by one aligned to vanishing points
# quantised to 1-degree accumulator bins, so its error against the scene is
# that of the bins, not of the 5-point pose.
VP_FRAMES, VP_CHUNK = 17, 16
VP_ROT_GT_DEG = 2.0         # max rotation error of a pair vs the scene

# P1's float operations per hypothesis (the epipolar rows 25, Householder
# 2290, the degree-2 products 956, the constraints 3880, norms and
# division 610) and its bytes (pts1, pts2 in; null4, coeffs out)
P1_OPS, P1_BYTES = 7761, 80 + (36 + 200) * 4
# P3's and P4's float operations per sample of the 24 x 24 grid (each
# gradient plane's bilinear sample 7, magnitude 4, angle 2, bin 3, window
# 1, histogram 1: P3 25; P4 adds the rotated bin coordinates 16, the three
# trilinear splits 9, the orientation weights 2 and its up to 8 outputs'
# products and sums 20: 70) and per P4 slot (the two norms and
# divisions, 4 per output)
P3_OPS_PER_SAMPLE, P4_OPS_PER_SAMPLE, P4_OPS_PER_SLOT = 25, 70, 512


# The times of the kernels that a later design replaced, as chip_smoke.py
# measured them on the same work (PERF.md, Findings): the flushed, queued
# and device ms per chunk, NVIDIA H100 80GB HBM3 at 700 W
BEFORE_REDESIGN = {
    "five_point_coeffs": "a warp per hypothesis, 0.0512 ms flushed, 0.0399 "
                         "queued, 0.0369 device",
    "sift_orientation_hist": "a warp per slot, each lane walking all 576 "
                             "samples for its bins, 0.6754 ms flushed, "
                             "0.6563 queued, 0.6468 device",
    "fixed_order_bmm": "79 launches of a thread per output, 1.3608 ms "
                       "flushed, 1.6474 queued, 0.5617 device (PR 14)",
    "sift_descriptor": "a warp per slot, 2.5970 ms flushed, 2.3913 queued, "
                       "2.3766 device (PR 15)",
}


def _geometry_launches(kernels, ransac, calls):
    """P1's, P2's and P5-P8's launches in `calls` estimator calls at
    RansacConfig `ransac` (ops/kernels.py counts): P2 and P5-P8 as often as
    its solver and LO-RANSAC make them, P1 only for the 5-point solver."""
    return kernels.geometry_launches(calls, kernels.geometry_path(ransac))


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str) -> None:
    print(msg, flush=True)


def main() -> None:
    if not (HERE / "rpe_tpu_torch" / "csrc").is_dir():
        fail(f"rpe_tpu_torch/ not found beside {Path(__file__).name}")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE / "tests"))      # torch_judges

    import numpy as np
    from torch_judges import p1_judge

    from rpe_tpu_torch.config import EstimatorConfig, MatcherConfig, \
        RansacConfig, profile_config
    from rpe_tpu_torch.geometry import five_point as fp
    from rpe_tpu_torch.ops import extract as textract
    from rpe_tpu_torch.ops import kernels
    from rpe_tpu_torch.ops.atlas import band_tables
    from rpe_tpu_torch.ops.extract import extract_brief, extract_brief_plain
    from rpe_tpu_torch.ops.fast import fast_harris_rank_map, \
        fast_harris_rank_map_plain
    from rpe_tpu_torch.ops.match import argmin_mismatches, \
        l2sq_distance_matrix, mutual_nn_hamming, mutual_nn_hamming_plain, \
        mutual_nn_l2, mutual_nn_l2_plain, near_tie_ok, row_top2, \
        row_top2_plain
    from rpe_tpu_torch.ops.orb import PATCH, atlas_keypoints
    from rpe_tpu_torch.ops.pyramid import build_pyramid
    from rpe_tpu_torch.pipeline.estimator import estimate_sequence_batched
    from rpe_tpu_torch.utils.device import full_precision
    from rpe_tpu_torch.utils.synthetic import make_sequence, \
        rotation_error_deg

    OUT_DIR.mkdir(exist_ok=True)
    dev = torch.device("cuda")
    full_precision()

    # ---- 1. card -----------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 \
        else f"nvidia-smi failed: {smi.stderr.strip()}"
    name = torch.cuda.get_device_name(0)
    say(f"card: {name} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")
    say(f"nvidia-smi: {card}")

    # ---- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    kernels.build_all()
    say(f"build: {len(kernels.SOURCES)} sources ({len(kernels.KERNELS)} "
        f"kernels) in {time.perf_counter() - t0:.1f} s")
    with open(OUT_DIR / "chip_smoke_build.log", "w") as f:
        for k, log in kernels.PTXAS_LOG.items():
            f.write(f"--- {k}\n{log}\n")
            for line in log.splitlines():
                if ("registers" in line or "spill" in line
                        or "Compiling entry" in line):
                    say(f"ptxas[{k}]: {line.strip()}")

    # ---- 3. kernels against their plain versions ------------------------------
    cfg = EstimatorConfig()
    cfg_a = EstimatorConfig(feature_method="SIFT",
                            matcher=MatcherConfig(norm_type="l2"))
    cfg_b = EstimatorConfig(feature_method="SIFT", matcher=MatcherConfig(
        norm_type="l2", cross_check=False))
    cfg_orb_ratio = EstimatorConfig(matcher=MatcherConfig(cross_check=False))
    o = cfg.orb
    frames, K, (R_gt, _) = make_sequence(9, H, W, seed=0)
    imgs = torch.from_numpy(frames).to(dev)
    flush = torch.empty(128 * 1024 * 1024, dtype=torch.uint8, device=dev)

    def cuda_ms(fn, iters=10):
        """Mean of per-launch CUDA-event times, L2 flushed before each."""
        fn()
        torch.cuda.synchronize()
        tot = 0.0
        for _ in range(iters):
            flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            torch.cuda.synchronize()
            tot += s.elapsed_time(e)
        return tot / iters

    def queued_ms(fn, calls=20):
        """CUDA-event time per call of `calls` calls queued back to back
        (the host's launch work hides behind the card's)."""
        fn()
        torch.cuda.synchronize()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / calls

    queued = {}
    device = {}

    def device_ms(fn, frag, reps=5):
        """Device time per call of the kernels whose name holds `frag`
        (torch.profiler's device events), over `reps` calls."""
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        return sum(e.time_range.elapsed_us() for e in prof.events()
                   if frag in e.name and str(getattr(
                       e, "device_type", "")).endswith("CUDA")) / reps / 1e3

    def bound(nbytes, ops, rate):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / rate
        return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"

    rows = {}
    failures = []

    def check(name, ok, msg):
        say(f"{name}: {'PASS' if ok else 'FAIL'} {msg}")
        if not ok:
            failures.append(f"{name}: {msg}")

    # K1 -- FAST/Harris rank map + blur on the 9 frames' atlases
    kp = atlas_keypoints(imgs, o.nfeatures, o.nlevels, o.scale_factor,
                         o.fast_threshold, o.max_kpts)
    atlas = kp["atlas"].contiguous()
    nf, ha, wp = atlas.shape
    def k1_contract(img):
        """K1 against its plain version on `img` (F, H, W): bit equality
        over the interior and, over the whole image, against the plain
        version run on the wrap-padded image (every stage wrapping at the
        edges, as the kernel's edge tiles do)."""
        m = 8
        rk, bk = fast_harris_rank_map(img, o.fast_threshold)
        rp, bp = fast_harris_rank_map_plain(img, o.fast_threshold)
        a, b = rk[:, m:-m, m:-m], rp[:, m:-m, m:-m]
        fin = torch.isfinite(b)
        res = dict(
            same_set=bool(torch.equal(torch.isfinite(a), fin)),
            rel=float(((a[fin] - b[fin]).abs() / (b[fin].abs() + 1e-3)).max())
            if bool(fin.any()) else 0.0,
            blur_err=float((bk[:, m:-m, m:-m] - bp[:, m:-m, m:-m]).abs()
                           .max()),
            interior_eq=bool(torch.equal(a, b) and torch.equal(
                bk[:, m:-m, m:-m], bp[:, m:-m, m:-m])),
            corners=int(fin.sum()),
            edge=int((rk != rp).sum() + (bk != bp).sum()))
        pad = torch.nn.functional.pad(img[:, None], (m,) * 4, mode="circular")
        rw, bw = (x[:, m:-m, m:-m] for x in fast_harris_rank_map_plain(
            pad[:, 0], o.fast_threshold))
        res["whole_eq"] = bool(torch.equal(rk, rw) and torch.equal(bk, bw))
        res["ok"] = (res["interior_eq"] and res["whole_eq"]
                     and res["same_set"] and res["rel"] < 1e-3
                     and res["blur_err"] < 1e-3)
        return res

    def k1_msg(r, what):
        return (f"{what}, rank and blur bit-equal over the interior (8 px "
                f"from the edges)={r['interior_eq']} and over the whole image "
                f"to the plain version on the wrap-padded image="
                f"{r['whole_eq']}; corner set equal={r['same_set']} "
                f"({r['corners']} corners), harris max rel err "
                f"{r['rel']:.3e} (< 1e-3), blur max abs err "
                f"{r['blur_err']:.3e} (< 1e-3); {r['edge']} edge-band values "
                f"differ from the unpadded plain version (its zero and -inf "
                f"padding)")

    k1 = k1_contract(atlas)
    blur_err = k1["blur_err"]
    check("K1 fast_harris", k1["ok"], k1_msg(k1, f"{nf} atlases"))
    px = nf * ha * wp
    b_ms, b_by = bound(3 * 4 * px, 180 * px, FP32_OPS_PER_S)
    rows["fast_harris"] = dict(
        name="fast_harris", route="cuda",
        source="rpe_tpu_torch/csrc/fast_harris.cu",
        replaces="rpe_tpu/ops/fast_pallas.py:177",
        max_abs_err=blur_err,
        ms=cuda_ms(lambda: fast_harris_rank_map(atlas, o.fast_threshold)),
        plain_ms=cuda_ms(lambda: fast_harris_rank_map_plain(
            atlas, o.fast_threshold), iters=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    queued["fast_harris"] = queued_ms(
        lambda: fast_harris_rank_map(atlas, o.fast_threshold))

    # K2 -- extraction + BRIEF on those frames' real band tables
    tb = band_tables(ha, wp, kp["xy_atlas"], kp["valid"], patch=PATCH,
                     cap=o.extract_cap, band=o.band)
    blurred = kp["blurred"].contiguous()
    args = (atlas, blurred, tb["tbl_x0"], tb["rel_y"], tb["band"])
    bits_k, m10_k, m01_k = extract_brief(*args)
    bits_p, m10_p, m01_p = extract_brief_plain(*args)
    live = (tb["rel_y"] >= 0).reshape(nf, -1)
    agree = float((bits_k == bits_p)[live].float().mean())
    mom_ok = bool(torch.allclose(m10_k, m10_p, rtol=1e-4, atol=2.0)
                  and torch.allclose(m01_k, m01_p, rtol=1e-4, atol=2.0))
    mom_err = float(torch.maximum((m10_k - m10_p).abs().max(),
                                  (m01_k - m01_p).abs().max()))
    parked_zero = bool((bits_k[~live] == 0).all()
                       and (m10_k[~live] == 0).all()
                       and (m01_k[~live] == 0).all())
    nb, cap = tb["tbl_x0"].shape[1:]
    check("K2 extract_brief", agree >= 0.999 and mom_ok and parked_zero,
          f"{int(live.sum())} live of {nf * nb * cap} slots, bit agreement "
          f"{agree:.6f} (>= 0.999), moments allclose(rtol 1e-4, atol 2)="
          f"{mom_ok} (max abs err {mom_err:.3e}), parked slots zero="
          f"{parked_zero}")
    n_live = int(live.sum())
    n_slots = nf * nb * cap
    # Bytes: the pixels that some live slot needs, each read once -- of the
    # raw atlas those under its IC mask; of the blurred atlas those its
    # samples reach at this run's angles (K2, K12: the plain version's
    # moments) or its whole patch (K8-K10) -- the slot tables, the static
    # tables and the outputs. Operations: 4 per masked raw pixel (the
    # moments), then the steering and the 256 comparisons per live slot.
    feet = brief_footprints(torch, m10_p, m01_p, live)
    raw_px, blur_px, k2_px, k12_px = (
        union_px(torch, tb["tbl_x0"], tb["rel_y"], tb["band"], ha, wp,
                 feet[k]) for k in ("ic", "whole", "k2", "k12"))
    n_ic = int(feet["ic"].numel())
    say(f"extraction bounds: of {px} px per atlas, {raw_px} raw px lie "
        f"under live slots' IC masks ({n_ic} of {PATCH * PATCH} a patch); "
        f"blurred px that live slots sample: K2 {k2_px}, K12 {k12_px}, "
        f"under their whole patches {blur_px}")
    slot_bytes = 2 * 4 * n_slots
    brief_out = n_slots * (256 + 8)
    b_ms, b_by = bound(4 * (raw_px + k2_px) + slot_bytes + 256 * 16
                       + brief_out, n_live * (4 * n_ic + 256 * 12),
                       FP32_OPS_PER_S)
    rows["extract_brief"] = dict(
        name="extract_brief", route="cuda",
        source="rpe_tpu_torch/csrc/extract_brief.cu",
        replaces="rpe_tpu/ops/extract_pallas.py:931",
        max_abs_err=mom_err, ms=cuda_ms(lambda: extract_brief(*args)),
        plain_ms=cuda_ms(lambda: extract_brief_plain(*args), iters=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    queued["extract_brief"] = queued_ms(lambda: extract_brief(*args))

    # K8, K9, K10 (patch kernels) and K12 (binned BRIEF) on the same tables:
    # K8 reads both atlases' whole patches, K9 and K10 the raw pixels under
    # the IC masks and the blurred whole patches
    patch_bytes = n_slots * PATCH * PATCH * 4
    mom_ops = n_live * 4 * n_ic
    for kn, name, replaces, n_patches, ops in (
            (8, "extract_patches", 1088, 2, 0),
            (9, "extract_patches_moments", 129, 1, mom_ops),
            (10, "extract_patches_t", 296, 1, mom_ops)):
        kern = getattr(textract, name)
        plain = getattr(textract, name + "_plain")
        got, want = kern(*args), plain(*args)
        same = [bool(torch.equal(x, y)) for x, y in zip(got, want)]
        if name == "extract_patches":
            ok, err, what = all(same), 0.0, f"raw and blur identical={same}"
        else:
            close = all(bool(torch.allclose(x, y, rtol=1e-4, atol=2.0))
                        for x, y in zip(got[1:], want[1:]))
            ok = same[0] and close
            err = float(max((got[1] - want[1]).abs().max(),
                            (got[2] - want[2]).abs().max()))
            k2_same = bool(torch.equal(got[1], m10_k)
                           and torch.equal(got[2], m01_k))
            ok = ok and k2_same
            what = (f"blur{' (transposed)' if name.endswith('_t') else ''} "
                    f"identical={same[0]}, moments allclose(rtol 1e-4, atol "
                    f"2)={close} (max abs err {err:.3e}), moments equal to "
                    f"K2's={k2_same}")
        parked = all(bool((t[~live] == 0).all()) for t in got)
        check(f"K{kn} {name}", ok and parked,
              f"{int(live.sum())} live of {n_slots} slots, {what}, parked "
              f"slots zero={parked}")
        read_px = 2 * blur_px if n_patches == 2 else raw_px + blur_px
        out_bytes = n_patches * patch_bytes + (0 if n_patches == 2
                                               else 2 * 4 * n_slots)
        b_ms, b_by = bound(4 * read_px + slot_bytes + out_bytes, ops,
                           FP32_OPS_PER_S)
        rows[name] = dict(
            name=name, route="cuda",
            source="rpe_tpu_torch/csrc/extract_patches.cu",
            replaces=f"rpe_tpu/ops/extract_pallas.py:{replaces}",
            max_abs_err=err, ms=cuda_ms(lambda: kern(*args)),
            plain_ms=cuda_ms(lambda: plain(*args), iters=3),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        queued[name] = queued_ms(lambda: kern(*args))
        del got, want

    # K8, K9, K10 on edge-slot tables: live, parked, constant-raw and
    # past-edge slots (rows and columns clamp to the atlas), one layout
    # whose slot count is not a multiple of 4
    for f_e, nb_e, cap_e in ((2, 8, 72), (1, 7, 71)):
        eargs, elive, econst = _edge_slots(torch, np, dev, f_e, nb_e, cap_e)
        _, e10, e01 = extract_brief(*eargs)
        for kn, name in ((8, "extract_patches"),
                         (9, "extract_patches_moments"),
                         (10, "extract_patches_t")):
            got = getattr(textract, name)(*eargs)
            want = getattr(textract, name + "_plain")(*eargs)
            same = [bool(torch.equal(x, y)) for x, y in zip(got, want)]
            parked = all(bool((t[~elive] == 0).all()) for t in got)
            if name == "extract_patches":
                ok, what = all(same), f"raw and blur identical={same}"
            else:
                close = all(bool(torch.allclose(x, y, rtol=1e-4, atol=2.0))
                            for x, y in zip(got[1:], want[1:]))
                k2_same = bool(torch.equal(got[1], e10)
                               and torch.equal(got[2], e01))
                const0 = not (bool(got[1][econst].any())
                              or bool(got[2][econst].any()))
                ok = same[0] and close and k2_same and const0
                what = (f"blur identical={same[0]}, moments allclose(rtol "
                        f"1e-4, atol 2)={close}, equal to K2's={k2_same}, 0 "
                        f"on constant raw patches={const0}")
            check(f"K{kn} {name} (edge slots, F={f_e}, {nb_e}x{cap_e})",
                  ok and parked, f"{int(elive.sum())} live of "
                  f"{f_e * nb_e * cap_e} slots, {what}, parked slots zero="
                  f"{parked}")
        del eargs, got, want

    bits_k, m10_k, m01_k = extract_brief(*args, binned=True)
    bits_p, m10_p, m01_p = extract_brief_plain(*args, binned=True)
    agree = float((bits_k == bits_p)[live].float().mean())
    mom_ok = bool(torch.allclose(m10_k, m10_p, rtol=1e-4, atol=2.0)
                  and torch.allclose(m01_k, m01_p, rtol=1e-4, atol=2.0))
    mom_err = float(torch.maximum((m10_k - m10_p).abs().max(),
                                  (m01_k - m01_p).abs().max()))
    parked_zero = bool((bits_k[~live] == 0).all()
                       and (m10_k[~live] == 0).all()
                       and (m01_k[~live] == 0).all())
    check("K12 extract_brief_binned", agree >= 0.999 and mom_ok
          and parked_zero,
          f"{int(live.sum())} live of {n_slots} slots, bit agreement "
          f"{agree:.6f} (>= 0.999), moments allclose(rtol 1e-4, atol 2)="
          f"{mom_ok} (max abs err {mom_err:.3e}), parked slots zero="
          f"{parked_zero}")
    b_ms, b_by = bound(4 * (raw_px + k12_px) + slot_bytes + 30 * 256 * 4
                       + 60 * 4 + brief_out,
                       n_live * (4 * n_ic + 30 * 3 + 256), FP32_OPS_PER_S)
    rows["extract_brief_binned"] = dict(
        name="extract_brief_binned", route="cuda",
        source="rpe_tpu_torch/csrc/extract_brief.cu",
        replaces="rpe_tpu/ops/extract_pallas.py:733",
        max_abs_err=mom_err,
        ms=cuda_ms(lambda: extract_brief(*args, binned=True)),
        plain_ms=cuda_ms(lambda: extract_brief_plain(*args, binned=True),
                         iters=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    queued["extract_brief_binned"] = queued_ms(
        lambda: extract_brief(*args, binned=True))

    # K1 on the per-level path's inputs (RPE_NO_ATLAS): levels 0 and 11 of
    # the 9 frames' pyramids, held as on the atlas; time and bound as K1's
    modes = {}
    levels = build_pyramid(imgs, o.nlevels, o.scale_factor)
    for lv in (0, o.nlevels - 1):
        img_l = levels[lv].contiguous()
        r = k1_contract(img_l)
        check(f"K1 fast_harris (level {lv}, {tuple(img_l.shape)})", r["ok"],
              k1_msg(r, f"{nf} level-{lv} images"))
        px_l = img_l.numel()
        b_ms, b_by = bound(3 * 4 * px_l, 180 * px_l, FP32_OPS_PER_S)
        modes[f"fast_harris level {lv}"] = dict(
            shape=list(img_l.shape), max_abs_err=r["blur_err"],
            ms=cuda_ms(lambda x=img_l: fast_harris_rank_map(
                x, o.fast_threshold)),
            plain_ms=cuda_ms(lambda x=img_l: fast_harris_rank_map_plain(
                x, o.fast_threshold), iters=3),
            queued_ms=queued_ms(lambda x=img_l: fast_harris_rank_map(
                x, o.fast_threshold)),
            bound_ms=b_ms, bound_by=b_by)
    del levels, img_l

    # K2 and K12 in the modes RPE_BRIEF and RPE_BRIEF_QUANT ask for, on the
    # same tables: OpenCV's pattern with rounded samples (the wide sample
    # radius: the whole blurred patch copied) and, for K2, the default
    # pattern with rounded samples; the default mode's contracts. Bytes as
    # the default mode's, with the blurred pixels this mode's samples
    # reach; operations one more per sample where they are rounded.
    for kn, binned, kind in ((2, False, "cv2"), (12, True, "cv2"),
                             (2, False, "gauss")):
        name = "extract_brief_binned" if binned else "extract_brief"
        kw = dict(binned=binned, quant=True, kind=kind)
        bits_k, m10_k2, m01_k2 = extract_brief(*args, **kw)
        bits_p, m10_p2, m01_p2 = extract_brief_plain(*args, **kw)
        agree = float((bits_k == bits_p)[live].float().mean())
        mom_ok = bool(torch.allclose(m10_k2, m10_p2, rtol=1e-4, atol=2.0)
                      and torch.allclose(m01_k2, m01_p2, rtol=1e-4, atol=2.0))
        mom_err = float(torch.maximum((m10_k2 - m10_p2).abs().max(),
                                      (m01_k2 - m01_p2).abs().max()))
        parked_zero = bool((bits_k[~live] == 0).all()
                           and (m10_k2[~live] == 0).all())
        default = extract_brief(*args, binned=binned, quant=False,
                                kind="gauss")[0]
        moved = float((bits_k != default)[live].float().mean())
        check(f"K{kn} {name} ({kind} pattern, quant)",
              agree >= 0.999 and mom_ok and parked_zero,
              f"bit agreement with the plain version {agree:.6f} (>= "
              f"0.999), moments allclose(rtol 1e-4, atol 2)={mom_ok} (max "
              f"abs err {mom_err:.3e}), parked slots zero={parked_zero}; "
              f"{moved:.4f} of live bits differ from the default mode's")
        feet_m = brief_footprints(torch, m10_p2, m01_p2, live, kind)
        samp_px = union_px(torch, tb["tbl_x0"], tb["rel_y"], tb["band"], ha,
                           wp, feet_m["k12" if binned else "k2"])
        tables = (30 * 256 * 4 + 60 * 4) if binned else 256 * 16
        ops = n_live * (4 * n_ic + (30 * 3 + 256 if binned else 256 * 12)
                        + 512)
        b_ms, b_by = bound(4 * (raw_px + samp_px) + slot_bytes + tables
                           + brief_out, ops, FP32_OPS_PER_S)
        modes[f"{name} {kind} quant"] = dict(
            agree=agree, max_abs_err=mom_err, sampled_px=samp_px,
            ms=cuda_ms(lambda kw=kw: extract_brief(*args, **kw)),
            plain_ms=cuda_ms(lambda kw=kw: extract_brief_plain(*args, **kw),
                             iters=3),
            queued_ms=queued_ms(lambda kw=kw: extract_brief(*args, **kw)),
            bound_ms=b_ms, bound_by=b_by)
        del bits_k, bits_p, default
    for k, v in modes.items():
        say(f"mode {k}: {v['ms']:.4f} ms flushed, {v['queued_ms']:.4f} ms "
            f"queued, plain {v['plain_ms']:.3f} ms, bound {v['bound_ms']:.4f}"
            f" ms ({v['bound_by']}; {card})")

    # detections of all 9 frames feed K3, K6-Hamming and K4 at main-path
    # shapes
    from rpe_tpu_torch.pipeline.estimator import detect_features
    with torch.no_grad():
        dets = detect_features(imgs, cfg)
    npair = nf - 1

    def pair_inputs(d, key):
        """The chunk's pairs, as the paths' matchers get them: frames 0-7
        against frames 1-8."""
        return (d[key][:-1].contiguous(), d[key][1:].contiguous(),
                d["valid"][:-1].contiguous(), d["valid"][1:].contiguous())

    def valid_cells(v1, v2):
        """Valid rows x valid columns, summed over the pairs."""
        return float((v1.sum(-1).double() * v2.sum(-1).double()).sum())

    # K3 -- Hamming mutual NN of the 8 pairs at 4096 x 4096
    b1, b2, v1, v2 = pair_inputs(dets, "bits")
    outk = mutual_nn_hamming(b1, b2, v1, v2)
    outp = mutual_nn_hamming_plain(b1, b2, v1, v2)
    same = [bool(torch.equal(x, y)) for x, y in zip(outk, outp)]
    n1, n2 = b1.shape[1], b2.shape[1]
    fin = outp[0] < 3.0e38
    k3_err = float((outk[0][fin] - outp[0][fin]).abs().max()) \
        if bool(fin.any()) else 0.0
    nv1, nv2 = int(v1.sum()), int(v2.sum())
    check("K3 match_hamming", all(same),
          f"{npair} pairs of {n1}x{n2}, {nv1}/{nv2} valid rows/columns, "
          f"identical best_d/nn12/nn21 = {same}")
    a16 = b1.to(torch.bfloat16)
    c16 = b2.to(torch.bfloat16).transpose(-1, -2)
    # the valid rows' and columns' bits, both masks and the three outputs;
    # distances over valid rows x valid columns only
    ham_ops = 2.0 * valid_cells(v1, v2) * 256
    b_ms, b_by = bound((nv1 + nv2) * 256 + npair * (n1 + n2)
                       + 4 * npair * (2 * n1 + n2), ham_ops, INT8_TC_OPS_PER_S)
    rows["match_hamming"] = dict(
        name="match_hamming", route="cuda",
        source="rpe_tpu_torch/csrc/match_hamming.cu",
        replaces="rpe_tpu/ops/match_pallas.py:180",
        max_abs_err=k3_err,
        ms=cuda_ms(lambda: mutual_nn_hamming(b1, b2, v1, v2)),
        plain_ms=cuda_ms(lambda: mutual_nn_hamming_plain(b1, b2, v1, v2),
                         iters=3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.matmul(a16, c16)))

    # K6, Hamming mode -- row top-2 of the same ORB bits (exact)
    outk = row_top2(b1, b2, v1, v2, "hamming")
    outp = row_top2_plain(b1, b2, v1, v2, "hamming")
    same = [bool(torch.equal(x, y)) for x, y in zip(outk, outp)]
    check("K6 row_top2_hamming", all(same),
          f"{npair} pairs of {n1}x{n2}, identical d1/a1/d2 = {same}, rows "
          f"with a second valid column {int((outp[2] < 3.0e38).sum())}")
    b_ms, b_by = bound((nv1 + nv2) * 256 + npair * (n1 + n2)
                       + 4 * 3 * npair * n1, ham_ops, INT8_TC_OPS_PER_S)
    rows["row_top2_hamming"] = dict(
        name="row_top2_hamming", route="cuda",
        source="rpe_tpu_torch/csrc/match_hamming.cu",
        replaces="rpe_tpu/ops/match_pallas.py:111",
        max_abs_err=float(max((outk[0] - outp[0]).abs().max(),
                              (outk[2] - outp[2]).abs().max())),
        ms=cuda_ms(lambda: row_top2(b1, b2, v1, v2, "hamming")),
        plain_ms=cuda_ms(lambda: row_top2_plain(b1, b2, v1, v2, "hamming"),
                         iters=3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.matmul(a16, c16)))
    del a16, c16

    # K7 and K6 (L2 mode) -- on the SIFT descriptors of the 8 pairs
    with torch.no_grad():
        sdets = detect_features(imgs, cfg_a)
    s1, s2, w1, w2 = pair_inputs(sdets, "desc")
    del sdets
    sn1, sn2 = s1.shape[1], s2.shape[1]
    sv1, sv2 = int(w1.sum()), int(w2.sum())
    big = torch.full((), 3.0e38, device=dev)
    Dm = torch.where(w1[..., :, None] & w2[..., None, :],
                     l2sq_distance_matrix(s1, s2), big)
    outk = mutual_nn_l2(s1, s2, w1, w2)
    outp = mutual_nn_l2_plain(s1, s2, w1, w2)
    rows_ok = w1 & (outp[0] < 3.0e38)
    cols_ok = w2 & (Dm.min(dim=-2).values < 3.0e38)
    m12 = argmin_mismatches(Dm, outk[1], outp[1], rows_ok, -1)
    m21 = argmin_mismatches(Dm, outk[2], outp[2], cols_ok, -2)
    k7_err = float((outk[0] - outp[0])[w1].abs().max())
    canon = bool((outk[0][~w1] == 3.0e38).all() and (outk[1][~w1] == 0).all()
                 and (outk[2][~w2] == 0).all())
    check("K7 match_l2", near_tie_ok(m12) and near_tie_ok(m21)
          and k7_err <= 1e-5 and canon,
          f"{npair} pairs of {sn1}x{sn2}x128, {sv1}/{sv2} valid rows/columns;"
          f" nn12 differs on {m12[0]} of {m12[1]} rows, nn21 on {m21[0]} of "
          f"{m21[1]} columns (each <= 0.1%, every one a near-tie: largest "
          f"distance gap {max(m12[2], m21[2]):.3e} <= 1e-5); best_d max abs "
          f"err {k7_err:.3e} (<= 1e-5); canonical invalid rows/columns="
          f"{canon}")
    s2t = s2.transpose(-1, -2)
    l2_ops = 2.0 * valid_cells(w1, w2) * 128
    b_ms, b_by = bound((sv1 + sv2) * 128 * 4 + npair * (sn1 + sn2)
                       + 4 * npair * (2 * sn1 + sn2), l2_ops,
                       TF32X3_TC_OPS_PER_S)
    rows["match_l2"] = dict(
        name="match_l2", route="cuda", source="rpe_tpu_torch/csrc/match_l2.cu",
        replaces="rpe_tpu/ops/match_pallas.py:242", max_abs_err=k7_err,
        ms=cuda_ms(lambda: mutual_nn_l2(s1, s2, w1, w2)),
        plain_ms=cuda_ms(lambda: mutual_nn_l2_plain(s1, s2, w1, w2),
                         iters=3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.matmul(s1, s2t)))

    outk = row_top2(s1, s2, w1, w2, "l2")
    outp = row_top2_plain(s1, s2, w1, w2, "l2")
    m1 = argmin_mismatches(Dm, outk[1], outp[1], rows_ok, -1)
    k6_err = float(max((outk[0] - outp[0])[w1].abs().max(),
                       (outk[2] - outp[2])[w1].abs().max()))
    canon = bool((outk[0][~w1] == 3.0e38).all() and (outk[1][~w1] == 0).all()
                 and (outk[2][~w1] == 3.0e38).all())
    check("K6 row_top2_l2", near_tie_ok(m1) and k6_err <= 1e-5 and canon,
          f"{npair} pairs of {sn1}x{sn2}x128, a1 differs on {m1[0]} of "
          f"{m1[1]} rows (<= 0.1%, each a near-tie: largest gap "
          f"{m1[2]:.3e} <= 1e-5); d1/d2 max abs err {k6_err:.3e} (<= 1e-5); "
          f"canonical invalid rows={canon}")
    b_ms, b_by = bound((sv1 + sv2) * 128 * 4 + npair * (sn1 + sn2)
                       + 4 * 3 * npair * sn1, l2_ops, TF32X3_TC_OPS_PER_S)
    rows["row_top2_l2"] = dict(
        name="row_top2_l2", route="cuda", source="rpe_tpu_torch/csrc/match_l2.cu",
        replaces="rpe_tpu/ops/match_pallas.py:111", max_abs_err=k6_err,
        ms=cuda_ms(lambda: row_top2(s1, s2, w1, w2, "l2")),
        plain_ms=cuda_ms(lambda: row_top2_plain(s1, s2, w1, w2, "l2"),
                         iters=3),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: torch.matmul(s1, s2t)))
    del Dm, s1, s2, s2t, outk, outp

    # K4 -- 5-point roots on the coefficients of 8 pairs x 256 samples
    coeffs = _main_path_coeffs(torch, dets, cfg, K, dev)
    # K4 contract (tests/test_pallas_kernels.py:143-184) on (a) the
    # reference test's 9 noise-free minimal problems, (b) 2048 of them and
    # (c) the main path's coefficients: the kernel's roots solve the cubic
    # system -- every one at B = 9; beyond it a bracket can end on a pole
    # or on two close roots, and the reference's own finders leave such
    # roots marked (scripts/k4_root_residuals.py), so there the kernel may
    # leave no more of them than its plain version does on the same input.
    # The plain version's converged roots reappear among the kernel's. The
    # kernel undoes a polish that carries a root to |z| >= fp.ZKEEP (the
    # plain version keeps it, beyond the grid): it may undo no more roots
    # than the plain version's polish carries that far, plus one per
    # thousand of the plain version's roots (rounded up).
    c9 = _exact_minimal_coeffs(np, torch, fp, 9, dev)
    c2048 = _exact_minimal_coeffs(np, torch, fp, 2048, dev)
    for label, c in (
            ("exact problems, B=9", c9),
            ("exact problems, B=2048", c2048),
            ("main path", coeffs)):
        *kern, undone = fp._solve_roots_polished(c)
        plain = fp.solve_roots_plain(c)
        good, n_roots, worst, zmax, reproduced, n_conv, dz = \
            _five_point_contract(np, fp, c, kern, plain)
        good_p, n_p = _five_point_contract(np, fp, c, plain, plain)[:2]
        frac = reproduced / max(n_conv, 1)
        exact = label.startswith("exact")
        sound = (good == n_roots if c.shape[0] == 9
                 else n_roots - good <= n_p - good_p)
        zp = torch.where(plain[3], 1.0 / plain[2].abs(), plain[2].abs())
        n_far = int((plain[4] & (zp >= fp.ZKEEP)).sum())
        n_left, cap = int(undone.sum()), n_far + -(-n_p // 1000)
        check(f"K4 five_point_roots ({label})",
              sound and zmax < 1.2e3 and frac >= 0.95 and n_left <= cap
              and (n_roots >= 3 * c.shape[0] or not exact),
              f"B={c.shape[0]}, {n_roots} kernel roots"
              f"{' (>= 3B)' if exact else ''}, {n_roots - good} fail the "
              f"cubic system at 2e-4*scale^3 (worst ratio {worst:.3e}) vs "
              f"{n_p - good_p} of the plain version's {n_p} "
              f"({'none may' if c.shape[0] == 9 else 'no more'}), max |z| "
              f"{zmax:.3e} (< 1.2e3), plain converged roots reproduced "
              f"{reproduced}/{n_conv} = {frac:.4f} (>= 0.95), max |dz| "
              f"{dz:.3e}; polishes the kernel undid (|z| >= "
              f"{fp.ZKEEP:g}) {n_left} (<= {cap}: the plain version's "
              f"{n_far} beyond it + 1 per 1000 of its roots)")
    n_roots = int(kern[4].sum())
    bsz = coeffs.shape[0]
    k4_ops = bsz * 97 * 835 + n_roots * (10 * 835 + 11000)
    b_ms, b_by = bound(bsz * 800 + bsz * 10 * 14, k4_ops, FP32_OPS_PER_S)
    rows["five_point_roots"] = dict(
        name="five_point_roots", route="cuda",
        source="rpe_tpu_torch/csrc/five_point_roots.cu",
        replaces="rpe_tpu/ops/five_point_pallas.py:318",
        max_abs_err=dz, ms=cuda_ms(lambda: fp.solve_roots_polished(coeffs)),
        plain_ms=cuda_ms(lambda: fp.solve_roots_plain(coeffs), iters=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    queued["five_point_roots"] = queued_ms(
        lambda: fp.solve_roots_polished(coeffs))

    # K5 -- K4's brackets alone (contract: tests/test_pallas_kernels.py:
    # 92-140) on the reference test's 9 exact problems and on the 2048. The
    # kernel takes det M's sign from its pivot signs, the plain version
    # from the det's value; at a borderline near-zero evaluation the two
    # can differ (the reference says so of its own kernel,
    # rpe_tpu/ops/five_point_pallas.py:20-24), and a sign change found by
    # one side only moves that hypothesis's later slots. At B = 9 the
    # reference test's contract holds against the plain version: has_root
    # identical, every endpoint within one grid step, >= 90% within two
    # bisection widths. At B = 2048 the plain version run in float64
    # arbitrates: the kernel may be wrong against it on no more slots than
    # the float32 plain version, and >= 90% of its endpoints lie within two
    # bisection widths of it.
    for label, c in (("exact problems, B=9", c9),
                     ("exact problems, B=2048", c2048)):
        r = _bracket_contract(np, torch, fp, c)
        big = c.shape[0] > 9
        ok = ((r["k_wrong"] <= r["p_wrong"] and r["k_near"] >= 0.9) if big
              else (r["wrong"] == 0 and r["near"] >= 0.9)) and r["empty0"]
        check(f"K5 root_brackets ({label})", ok,
              f"{r['n_has']} brackets; against the plain version: has_root "
              f"differs on {r['n_diff']} slots, {r['wrong']} slots wrong "
              f"(has_root or an endpoint > one grid step {r['step']:.3e}), "
              f"max endpoint diff {r['err']:.3e}, {r['near']:.4f} within "
              f"two bisection widths"
              + (f"; against float64: kernel wrong on {r['k_wrong']} slots, "
                 f"plain on {r['p_wrong']} (kernel may not be wrong on "
                 f"more), kernel within two widths {r['k_near']:.4f} (>= "
                 f"0.9)" if big else " (none wrong, >= 0.9 within)")
              + f"; empty slots 0={r['empty0']}")
    b_ms, b_by = bound(2048 * (800 + fp.MAX_ROOTS * 9) + 97 * 4,
                       2048 * 97 * 835 + r["n_has"] * 10 * 835,
                       FP32_OPS_PER_S)
    rows["root_brackets"] = dict(
        name="root_brackets", route="cuda",
        source="rpe_tpu_torch/csrc/five_point_roots.cu",
        replaces="rpe_tpu/ops/five_point_pallas.py:385",
        # no path launches K5: the reference reaches it from its tests only
        launches=0, max_abs_err=r["err"],
        ms=cuda_ms(lambda: fp.find_root_brackets(c2048)),
        plain_ms=cuda_ms(lambda: fp.find_root_brackets_plain(c2048), iters=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    queued["root_brackets"] = queued_ms(lambda: fp.find_root_brackets(c2048))

    # P1 -- the constraint coefficients of the 8 pairs x 256 samples (K4's
    # input above), held by tests/torch_judges.py `p1_judge` (within 1e-5
    # of the float64 run on every hypothesis, and of the plain version
    # where that is itself within 1e-5 of the float64 run), and bit-equal
    # when the pairs are estimated in two calls
    s1, s2 = _main_path_samples(torch, dets, cfg, K, dev)
    n_k, c_k = fp.constraint_coeffs(s1, s2)
    n_p, c_p = fp.constraint_coeffs_plain(s1, s2)
    _, c_d = fp.constraint_coeffs_plain(s1.double(), s2.double())
    half = s1.shape[0] // 2
    parts = [fp.constraint_coeffs(s1[a:b], s2[a:b])
             for a, b in ((0, half), (half, s1.shape[0]))]
    p1_split = all(torch.equal(torch.cat([q[i] for q in parts]), x)
                   for i, x in enumerate((n_k, c_k)))
    p1_ok, p1_err, err_k, err_p, n_arb = p1_judge(c_k, c_p, c_d)
    pts = torch.cat([s1, s2], -1).reshape(-1, 5, 4)
    repeated = int(sum(len({tuple(r) for r in h}) < 5
                       for h in pts.cpu().tolist()))
    check("P1 five_point_coeffs", p1_ok and p1_split,
          f"{tuple(s1.shape[:2])} samples: max |kernel - plain| {p1_err:.3e}"
          f" (<= 1e-5) on the {pts.shape[0] - n_arb} whose plain float32 "
          f"coefficients are within 1e-5 of its float64 run (not on the "
          f"other {n_arb}; {repeated} samples repeat a point); against "
          f"float64 on all: kernel {err_k:.3e} (<= 1e-5 and <= plain + "
          f"1e-6), plain float32 {err_p:.3e}; max |kernel - plain| over all "
          f"{float((c_k - c_p).abs().max()):.3e}, null4 "
          f"{float((n_k - n_p).abs().max()):.3e}; bit-equal split in two "
          f"calls={p1_split}")
    m_h = s1.shape[0] * s1.shape[1]
    b_ms, b_by = bound(m_h * P1_BYTES, m_h * P1_OPS, FP32_OPS_PER_S)
    rows["five_point_coeffs"] = dict(
        name="five_point_coeffs", route="cuda",
        source="rpe_tpu_torch/csrc/five_point_coeffs.cu",
        # port-only: no Pallas kernel; the reference's XLA code it computes
        replaces="rpe_tpu/geometry/five_point.py:181", max_abs_err=p1_err,
        ms=cuda_ms(lambda: fp.constraint_coeffs(s1, s2)),
        plain_ms=cuda_ms(lambda: fp.constraint_coeffs_plain(s1, s2),
                         iters=3),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    queued["five_point_coeffs"] = queued_ms(
        lambda: fp.constraint_coeffs(s1, s2))
    device["five_point_coeffs"] = device_ms(
        lambda: fp.constraint_coeffs(s1, s2), "coeffs_kernel")

    # P2 -- every launch it makes in one call of the ORB path on the 9
    # frames, recorded from that call (a launch takes up to four products,
    # a chain of two as one): each product bit-equal to the serial float64
    # reference (tests/torch_judges.py `p2_serial`), held by `p2_judge` to
    # the float64 product and to torch.matmul / .sum(-1) (its plain
    # version, which is also the library call), and bit-equal when the
    # batch is split in two along the pair axis; timed as the call's whole
    # set of launches
    keys_np = np.stack([np.array([0, i], np.uint32) for i in range(8)])
    ops, p2_reads = _record_p2(torch, lambda: estimate_sequence_batched(
        frames, K, keys_np, cfg, device=dev))
    p2_ok, p2_err, p2_rel, p2_serial_diff, p2_split, p2_bytes, p2_flops = \
        _p2_contract(torch, ops, p2_reads)
    n_terms = sum(len(o) for o in ops)
    check("P2 fixed_order_bmm",
          p2_ok and p2_split and p2_serial_diff == 0
          and len(ops) == kernels.P2_PER_CALL,
          f"{len(ops)} launches of one ORB call (want "
          f"{kernels.P2_PER_CALL}), {n_terms} products and sums, shapes "
          f"{sorted({_op_shape(o) for o in ops}, key=str)}; products "
          f"differing from the serial float64 reference {p2_serial_diff} "
          f"(want 0); held to torch.matmul/.sum and float64={p2_ok} "
          f"(largest abs difference from the plain {p2_err:.3e}; relative "
          f"to sum|a||b|: kernel against float64 {p2_rel[0]:.3e} (<= "
          f"1e-6), kernel against plain {p2_rel[1]:.3e}, plain against "
          f"float64 {p2_rel[2]:.3e}); bit-equal split in two={p2_split}; "
          f"bytes read and written once {p2_bytes} (an element two "
          f"operands share counted once)")
    b_ms, b_by = bound(p2_bytes, p2_flops, FP32_OPS_PER_S)
    rows["fixed_order_bmm"] = dict(
        name="fixed_order_bmm", route="cuda",
        source="rpe_tpu_torch/csrc/fixed_order.cu",
        # port-only: no Pallas kernel; the reference's XLA dot it computes
        replaces="rpe_tpu/geometry/epipolar.py:77", max_abs_err=p2_err,
        ms=cuda_ms(lambda: [_p2_run(o) for o in ops]),
        plain_ms=cuda_ms(lambda: [_p2_plain(o) for o in ops]),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=cuda_ms(lambda: [_p2_plain(o) for o in ops]))
    queued["fixed_order_bmm"] = queued_ms(
        lambda: [_p2_run(o) for o in ops])
    device["fixed_order_bmm"] = device_ms(
        lambda: [_p2_run(o) for o in ops], "bmm_kernel")
    del ops

    # P5-P8 -- every call of the small solvers and of the threefry hash in
    # one call of the ORB path on the 9 frames, recorded from that call:
    # each bit-equal to its plain version run eagerly on the card (a NaN
    # where it has a NaN), P5-P7 also with the batch split in two; timed as
    # the call's whole set of launches of each kernel
    small = _record_small(torch, lambda: estimate_sequence_batched(
        frames, K, keys_np, cfg, device=dev))
    for name, calls in small.items():
        ok, split, n_out = _small_contract(torch, name, calls)
        want = kernels.SMALL_SOLVERS_PER_CALL["5pt"][name]
        check(f"{SMALL_LABELS[name]} {name}",
              ok and split and len(calls) == want,
              f"{len(calls)} calls of one ORB call (want {want}), shapes "
              f"{sorted({tuple(a.shape) for a, *_ in calls})}, "
              f"{n_out} outputs; bit-equal to the plain version run "
              f"eagerly={ok}; bit-equal split in two={split}")
        nbytes, nops = _small_work(name, calls)
        b_ms, b_by = bound(nbytes, nops, FP32_OPS_PER_S)
        rows[name] = dict(
            name=name, route="cuda",
            source="rpe_tpu_torch/csrc/small_solvers.cu",
            # port-only: no Pallas kernel; the reference's XLA chain
            replaces=SMALL_REPLACES[name], max_abs_err=0.0,
            ms=cuda_ms(lambda: _small_run(name, calls)),
            plain_ms=cuda_ms(lambda: _small_run(name, calls, plain=True),
                             iters=3),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        queued[name] = queued_ms(lambda: _small_run(name, calls))
        device[name] = device_ms(lambda: _small_run(name, calls),
                                 SMALL_KERNEL_NAMES[name])
    del small

    # P3, P4 -- every octave's inputs of one SIFT A chunk's detection (the
    # 9 frames), recorded from it; held by tests/torch_judges.py
    # `p3_judge` and `p4_judge`, bit-equal with the frames and with the
    # slots split in two, timed as the chunk's 5 launches of each
    ori_calls, desc_calls = _record_sift(
        torch, lambda: detect_features(imgs, cfg_a))
    rows.update(_sift_rows(torch, ori_calls, desc_calls, check, dict(
        cuda_ms=cuda_ms, queued_ms=queued_ms, device_ms=device_ms,
        bound=bound, queued=queued, device=device), card))
    del flush, ori_calls, desc_calls

    for r in rows.values():
        lib = ("none: no single PyTorch call computes it"
               if r["library_ms"] is None else f"{r['library_ms']:.4f}")
        q = (f" (queued {queued[r['name']]:.4f} ms per call)"
             if r["name"] in queued else "")
        if r["name"] in device:
            q += (f" (device {device[r['name']]:.4f} ms per call, "
                  f"{100 * r['bound_ms'] / device[r['name']]:.1f}% of the "
                  f"bound)")
        if r["name"] in BEFORE_REDESIGN:
            q += f" (before the redesign: {BEFORE_REDESIGN[r['name']]})"
        say(f"{r['name']}: kernel {r['ms']:.4f} ms{q}, plain "
            f"{r['plain_ms']:.4f} ms, bound {r['bound_ms']:.4f} ms "
            f"({r['bound_by']}; the kernel at "
            f"{100 * r['bound_ms'] / r['ms']:.1f}% of it), library {lib} ms"
            f" ({card})")

    # ---- 4. paths ---------------------------------------------------------------
    orb = ("fast_harris", "extract_brief")
    orb_k = orb + ("match_hamming", "five_point_roots")
    # (label, config, kernels launched -- each once unless counted --,
    # environment, whether the bits must equal the default route's)
    paths = [
        ("ORB cross-check", cfg, orb_k, {}, False),
        ("SIFT A (L2 cross-check)", cfg_a,
         {"match_l2": 1, "five_point_roots": 1}
         | kernels.sift_launches(H, W, cfg_a.sift), {}, False),
        ("SIFT B (L2 ratio)", cfg_b,
         {"row_top2_l2": 1, "five_point_roots": 1}
         | kernels.sift_launches(H, W, cfg_b.sift), {}, False),
        ("ORB ratio", cfg_orb_ratio,
         orb + ("row_top2_hamming", "five_point_roots"), {}, False),
    ]
    # the ORB path under the reference's other extraction gates: each
    # setting's kernel takes K2's place (ops/extract.py `extract_route`);
    # K8-K10's routes describe with K2's function
    for route, gates in (
            ("extract_brief_binned", {"RPE_EXTRACT_T_V7": "1"}),
            ("extract_patches_t", {"RPE_EXTRACT_T_BRIEF": "0"}),
            ("extract_patches_moments", {"RPE_EXTRACT_T": "0"}),
            ("extract_patches", {"RPE_EXTRACT_T": "0",
                                 "RPE_EXTRACT_MOMENTS": "0"})):
        paths.append((f"ORB {' '.join(f'{k}={v}' for k, v in gates.items())}",
                      cfg, ("fast_harris", route, "match_hamming",
                            "five_point_roots"), gates,
                      route != "extract_brief_binned"))
    # the ORB path under the reference's other switches: the per-level path
    # (K1 once per level, no extraction kernel), the unfused atlas, OpenCV's
    # BRIEF pattern (K2 or K12 in its wide, rounded mode), rounded samples
    # alone, and LO-RANSAC
    cfg_lo = EstimatorConfig(ransac=RansacConfig(lo=True))
    cfg_8pt = EstimatorConfig(ransac=RansacConfig(solver="8pt"))
    paths += [
        ("ORB RPE_NO_ATLAS=1", cfg, {"fast_harris": o.nlevels,
                                     "match_hamming": 1,
                                     "five_point_roots": 1},
         {"RPE_NO_ATLAS": "1"}, False),
        ("ORB RPE_NO_FUSED_ATLAS=1", cfg, orb_k,
         {"RPE_NO_FUSED_ATLAS": "1"}, False),
        ("ORB RPE_BRIEF=cv2", cfg, orb_k, {"RPE_BRIEF": "cv2"}, False),
        ("ORB RPE_BRIEF=cv2 RPE_EXTRACT_T_V7=1", cfg,
         ("fast_harris", "extract_brief_binned", "match_hamming",
          "five_point_roots"), {"RPE_BRIEF": "cv2", "RPE_EXTRACT_T_V7": "1"},
         False),
        ("ORB RPE_BRIEF_QUANT=1", cfg, orb_k, {"RPE_BRIEF_QUANT": "1"},
         False),
        ("ORB RansacConfig(lo=True)", cfg_lo, orb_k, {}, False),
        # the 8-point solver (the KITTI runner's --solver 8pt): no K4, no
        # P1; the ORB profiles orb2000 and orb1000 (--profile)
        ("ORB RansacConfig(solver='8pt')", cfg_8pt, orb + ("match_hamming",),
         {}, False),
        ("ORB profile orb2000", profile_config("orb2000"), orb_k, {}, False),
        ("ORB profile orb1000", profile_config("orb1000"), orb_k, {}, False),
    ]
    summary = {}
    for label, pcfg, expect, gates, same_bits in paths:
        if not isinstance(expect, dict):
            expect = {k: 1 for k in expect}
        expect = expect | _geometry_launches(kernels, pcfg.ransac, 1)
        with _gates(gates):
            estimate_sequence_batched(frames, K, keys_np, pcfg, device=dev)
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            out = estimate_sequence_batched(frames, K, keys_np, pcfg,
                                            device=dev)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = dict(kernels.LAUNCHES)
            say(f"[{label}] launches: {launches}")
            for k in expect:
                rows[k].setdefault("launches", launches[k])
            ran = {k: n for k, n in launches.items() if n > 0}
            if ran != expect:
                failures.append(f"{label}: launched {ran}, want {expect}")
            valid_cuda = out["valid"].cpu().numpy()
            R_cuda = out["R"].cpu().numpy()
            if not np.isfinite(R_cuda).all() or R_cuda.shape != (8, 3, 3):
                failures.append(f"{label}: R not finite (8, 3, 3): "
                                f"{R_cuda.shape}")
            err_gt = rotation_error_deg(R_cuda, R_gt[None])
            say(f"[{label}] valid {valid_cuda.tolist()}, matches "
                f"{out['num_matches'].cpu().tolist()}, inliers "
                f"{out['num_inliers'].cpu().tolist()}")
            say(f"[{label}] rotation error vs ground truth (deg): "
                f"{[round(float(e), 4) for e in err_gt]}")
            say(f"[{label}] throughput: {8 / dt:.3f} pairs/s (8 pairs, "
                f"1241x376, host clock + synchronize, {dt * 1e3:.1f} ms; "
                f"{card})")
            summary[label] = dict(pairs_per_s=8 / dt, launches=launches,
                                  valid=valid_cuda.tolist(),
                                  rot_err_gt_deg=[float(e) for e in err_gt])
            t0 = time.perf_counter()
            cpu = estimate_sequence_batched(frames[:3], K, keys_np[:2], pcfg,
                                            device="cpu")
            say(f"[{label}] CPU run of frames 0-2: "
                f"{time.perf_counter() - t0:.1f} s")
            valid_cpu = cpu["valid"].numpy()
            d_rot = rotation_error_deg(R_cuda[:2], cpu["R"].numpy())
            check(f"[{label}] CUDA vs CPU",
                  bool((valid_cpu == valid_cuda[:2]).all())
                  and bool((d_rot <= 0.5).all()),
                  f"valid cuda {valid_cuda[:2].tolist()} cpu "
                  f"{valid_cpu.tolist()}, rotation difference (deg) "
                  f"{[float(x) for x in d_rot]} (<= 0.5), matches cuda "
                  f"{out['num_matches'][:2].cpu().tolist()} cpu "
                  f"{cpu['num_matches'].tolist()}")
            if same_bits:
                # K8-K10's routes describe with K2's function: their bits
                # agree with the default route's on the same keypoints
                with torch.no_grad():
                    rd = detect_features(imgs, pcfg)
                same_kp = bool(torch.equal(rd["valid"], dets["valid"])
                               and torch.equal(rd["xy"], dets["xy"]))
                v = dets["valid"]
                agree = float((rd["bits"] == dets["bits"])[v].float().mean())
                check(f"[{label}] bits vs the default route",
                      same_kp and agree >= 0.999,
                      f"same keypoints={same_kp}, bit agreement {agree:.6f} "
                      f"(>= 0.999) over {int(v.sum())} keypoints")
                del rd

    # ---- 4b. the calibration tool (numpy on the host, the reference's own
    # design) on seeded synthetic chessboard views, two of them corrupted
    summary["calibration"] = _calibration_line(np, check)

    with tempfile.TemporaryDirectory() as seq_dir:
        # ---- 5. sequence runner ---------------------------------------------
        phase5 = {}
        summary["sequence runner"] = _runner_phase(
            torch, np, card, check, Path(seq_dir), phase5)

        # ---- 6. VP refinement and the dataset runners -----------------------
        room = Path(seq_dir) / "room"
        summary["vp runners"] = _vp_phase(torch, np, card, check,
                                          summary["sequence runner"], room)

        # ---- 7. multi-device: meshes on the one card ------------------------
        summary["multi-device"] = _mesh_phase(
            torch, np, card, check, Path(seq_dir), phase5,
            summary["sequence runner"], (frames, K, keys_np, cfg))

        # ---- 8. batch invariance --------------------------------------------
        summary["batch invariance"] = _batch_phase(
            torch, np, card, check, Path(seq_dir), phase5, room)

    if "--profile" in sys.argv:
        _profile_main_path(torch, np, estimate_sequence_batched,
                           {"ORB": cfg, "SIFT A": cfg_a, "SIFT B": cfg_b},
                           card)

    if failures:
        fail("; ".join(failures))
    line = {"kernels": [rows[k] for k in kernels.KERNELS]}
    with open(OUT_DIR / "chip_smoke.json", "w") as f:
        json.dump(dict(line, card=card, paths=summary, queued_ms=queued,
                       device_ms=device, modes=modes), f, indent=1)
    say(f"nvidia-smi: {card}")
    say(json.dumps(line))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _batch_phase(torch, np, card, check, tmp, phase5, room):
    """Phase 8 (module docstring): a pair's pose does not depend on the
    batch it is estimated in. Returns the numbers it printed."""
    from rpe_tpu_torch.config import EstimatorConfig, MatcherConfig, \
        RansacConfig, profile_config
    from rpe_tpu_torch.ops import kernels
    from rpe_tpu_torch.pipeline.estimator import detect_features, \
        estimate_sequence_batched
    from rpe_tpu_torch.utils.synthetic import make_sequence

    t_phase = time.perf_counter()
    n = SEQ_FRAMES - 1
    k1_k4 = ("fast_harris", "extract_brief", "match_hamming",
             "five_point_roots")
    frames, K, _ = make_sequence(SEQ_FRAMES, H, W, seed=0, step=SEQ_STEP,
                                 rot_deg=SEQ_ROT_DEG)
    imgs = torch.from_numpy(frames).cuda()
    keys = np.stack([np.array([0, i], np.uint32) for i in range(n)])
    fields = ("R", "t", "valid", "num_inliers", "num_matches")
    res = {}
    # the ORB path, the 8-point solver (K1-K3, no K4) and the orb2000
    # profile at every split
    for label, pcfg, ks in (
            ("ORB", EstimatorConfig(), k1_k4),
            ("ORB 8pt", EstimatorConfig(ransac=RansacConfig(solver="8pt")),
             k1_k4[:3]),
            ("ORB orb2000", profile_config("orb2000"), k1_k4)):
        tag = "[batch]" if label == "ORB" else f"[batch {label}]"
        pre = "" if label == "ORB" else f"{label} "
        runs = {}
        for size in (n, 16, 8, 1):
            calls = -(-n // size)
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            outs = [estimate_sequence_batched(imgs[a:a + size + 1], K,
                                              keys[a:a + size], pcfg)
                    for a in range(0, n, size)]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            ran = {k: v for k, v in kernels.LAUNCHES.items() if v}
            runs[size] = {k: torch.cat([o[k] for o in outs]) for k in fields}
            want = ({k: calls for k in ks}
                    | _geometry_launches(kernels, pcfg.ransac, calls))
            check(f"{tag} {calls} x {size} pairs launches", ran == want,
                  f"{ran} (want {want})")
            say(f"{tag} {calls} x {size} pairs: {n / dt:.3f} pairs/s "
                f"({card})")
            res[f"{pre}pairs_per_s {calls}x{size}"] = n / dt
        whole = runs[n]
        n_valid = int(whole["valid"].sum())
        if label == "ORB 8pt":
            say(f"{tag} one call of {n}: {n_valid} of {n} valid")
        else:
            check(f"{tag} every pair valid in one call", n_valid == n,
                  f"{n_valid} of {n} valid")
        for size in (16, 8, 1):
            same = {k: bool(torch.equal(runs[size][k], whole[k]))
                    for k in fields}
            dR = float((runs[size]["R"] - whole["R"]).abs().max())
            dt = float((runs[size]["t"] - whole["t"]).abs().max())
            check(f"{tag} {n // size} x {size} pairs against 1 x {n}",
                  all(same.values()),
                  f"bit-equal {same}; max |dR| {dR!r}, |dt| {dt!r}")
            res[f"{pre}max_abs_dR {size}"] = dR

    # the KITTI runner at --chunk 32 against phase 5's --chunk 16
    base = phase5["base"]
    assert base[-2:] == ["--chunk", str(SEQ_CHUNK)]
    out, _ = _run_runner(base[:-2] + [
        "--chunk", str(2 * SEQ_CHUNK), "--checkpoint",
        str(tmp / "chunk32.jsonl"), "--results-dir", str(tmp / "chunk32")],
        tag="[batch]")
    R32, v32 = _pair_rotations(np, _ckpt_records(tmp / "chunk32.jsonl"), n)
    ate = (out["ate_sim3"]["rmse"], phase5["out"]["ate_sim3"]["rmse"])
    same_R = bool(np.array_equal(R32, phase5["R"]))
    check("[batch] runner --chunk 32 against --chunk 16",
          same_R and v32 == phase5["valid"] and ate[0] == ate[1],
          f"per-pair R equal={same_R} (max |dR| "
          f"{float(np.abs(R32 - phase5['R']).max())!r}), valid equal="
          f"{v32 == phase5['valid']}, ATE sim3 RMSE {ate[0]!r} against "
          f"{ate[1]!r}")
    res.update(runner_chunk32_R_equal=same_R, ate_chunk32=ate[0],
               ate_chunk16=ate[1])

    # SIFT A at every split, SIFT B at 32 against 8 x 4: detections, poses
    # and launches
    cfg_a = EstimatorConfig(feature_method="SIFT",
                            matcher=MatcherConfig(norm_type="l2"))
    cfg_b = EstimatorConfig(feature_method="SIFT", matcher=MatcherConfig(
        norm_type="l2", cross_check=False))
    for label, scfg, sizes, matcher in (
            ("SIFT A", cfg_a, (n, 16, 8, 1), "match_l2"),
            ("SIFT B", cfg_b, (n, 8), "row_top2_l2")):
        sruns = {}
        for size in sizes:
            calls = -(-n // size)
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            outs = [estimate_sequence_batched(imgs[a:a + size + 1], K,
                                              keys[a:a + size], scfg)
                    for a in range(0, n, size)]
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            ran = {k: v for k, v in kernels.LAUNCHES.items() if v}
            sruns[size] = {k: torch.cat([o[k] for o in outs])
                           for k in fields}
            want = ({matcher: calls, "five_point_roots": calls}
                    | kernels.geometry_launches(calls)
                    | kernels.sift_launches(H, W, scfg.sift, calls))
            check(f"[batch {label}] {calls} x {size} pairs launches",
                  ran == want, f"{ran} (want {want})")
            say(f"[batch {label}] {calls} x {size} pairs: {n / dt:.3f} "
                f"pairs/s ({card})")
            res[f"{label} pairs_per_s {calls}x{size}"] = n / dt
        whole = sruns[n]
        say(f"[batch {label}] one call of {n}: {int(whole['valid'].sum())} "
            f"valid, matches {whole['num_matches'].cpu().tolist()}")
        for size in sizes[1:]:
            same = {k: bool(torch.equal(sruns[size][k], whole[k]))
                    for k in fields}
            dR = float((sruns[size]["R"] - whole["R"]).abs().max())
            dm = int((sruns[size]["num_matches"] - whole["num_matches"])
                     .abs().max())
            check(f"[batch {label}] {n // size} x {size} pairs against 1 x "
                  f"{n}", all(same.values()),
                  f"bit-equal {same}; max |dR| {dR!r}, |d matches| {dm}")
            res[f"{label} max_abs_dR {size}"] = dR
    with torch.no_grad():
        dets = detect_features(imgs, cfg_a)
        for size in (16, 8, 1):
            same = True
            for a in range(0, n, size):
                sl = slice(a, min(a + size, n) + 1)
                part = detect_features(imgs[sl], cfg_a)
                same &= all(torch.equal(dets[k][sl], part[k]) for k in dets)
            check(f"[batch SIFT A] detections of {size}-pair chunks "
                  f"against one call", same,
                  f"xy, angle, level, score, desc, valid bit-equal={same}")
    del dets

    # the simulator runner with --feature SIFT on phase 6's room
    res["sift runner"] = _sift_runner_chunks(torch, np, check, tmp, room,
                                             card)
    res["phase_s"] = time.perf_counter() - t_phase
    say(f"[batch] phase: {res['phase_s']:.1f} s")
    return res


def _sift_runner_chunks(torch, np, check, tmp, room, card):
    """Phase 8's simulator runner with --feature SIFT on phase 6's room at
    --chunk 16 and --chunk 8: per-pair R and `valid` equal, K7, K4 and P1
    once per chunk, P2 `P2_PER_CALL` times, P3 and P4 once per octave."""
    import io

    from rpe_tpu_torch.cli import run_simulator_data
    from rpe_tpu_torch.config import SiftConfig
    from rpe_tpu_torch.ops import kernels

    got = {}
    n_pairs = VP_FRAMES - 1
    for chunk in (16, 8):
        calls = -(-n_pairs // chunk)
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            out = run_simulator_data.main(
                ["--data-root", str(room), "--results-dir",
                 str(tmp / f"sift_chunk{chunk}"), "--step", "1", "--chunk",
                 str(chunk), "--no-video", "--feature", "SIFT"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = {k: v for k, v in kernels.LAUNCHES.items() if v}
        want = ({"match_l2": calls, "five_point_roots": calls}
                | kernels.geometry_launches(calls)
                | kernels.sift_launches(H, W, SiftConfig(), calls))
        check(f"[batch SIFT runner] --chunk {chunk} launches", ran == want,
              f"{ran} (want {want})")
        est = out["estimated"]
        got[chunk] = (np.stack(est["R"]), [bool(v) for v in est["valid"]])
        say(f"[batch SIFT runner] --chunk {chunk}: {sum(got[chunk][1])} of "
            f"{n_pairs} pairs valid, {wall:.2f} s with VP ({card})")
    same_R = bool(np.array_equal(got[16][0], got[8][0]))
    check("[batch SIFT runner] --chunk 8 against --chunk 16",
          same_R and got[16][1] == got[8][1],
          f"per-pair R equal={same_R} (max |dR| "
          f"{float(np.abs(got[16][0] - got[8][0]).max())!r}), valid equal="
          f"{got[16][1] == got[8][1]}")
    return dict(R_equal=same_R, valid=got[16][1])


def _record_sift(torch, run):
    """The arguments of every P3 (`orientation_hist`) and P4
    (`descriptor`) call that run() makes, octave by octave."""
    from rpe_tpu_torch.ops import sift

    ori_calls, desc_calls = [], []
    ori, desc = sift.orientation_hist, sift.descriptor

    def rec_ori(*a):
        ori_calls.append(a)
        return ori(*a)

    def rec_desc(*a):
        desc_calls.append(a)
        return desc(*a)

    sift.orientation_hist, sift.descriptor = rec_ori, rec_desc
    try:
        with torch.no_grad():
            run()
    finally:
        sift.orientation_hist, sift.descriptor = ori, desc
    return ori_calls, desc_calls


def _sampled_px(torch, ucx, ucy, radius, lin, py, px):
    """The pixels each slot's bilinear taps read in one gradient plane:
    the distinct rows {y0, y0 + 1} times the distinct columns of its grid
    (ops/sift.py `_sep_weights`), (F, Q) int64."""
    def distinct(u, p):
        u0 = torch.floor(u.clamp(1.0, p - 2.001))
        v = torch.sort(torch.cat([u0, u0 + 1], -1), -1).values
        return 1 + (v[..., 1:] != v[..., :-1]).sum(-1)

    lin = torch.from_numpy(lin).to(ucx.device)
    return (distinct(ucy[..., None] + lin * radius[..., None], py)
            * distinct(ucx[..., None] + lin * radius[..., None], px))


def _sift_rows(torch, ori_calls, desc_calls, check, t, card):
    """Phase 3's P3 and P4 rows (module docstring) on the recorded inputs
    of one chunk's detection, octave by octave."""
    import math

    from torch_judges import p3_judge, p3_references, p3_serial, p4_judge

    from rpe_tpu_torch.ops import sift

    dev = ori_calls[0][0].device
    tables = sift._device_tables(dev).numel() * 4
    lin_o, _, lin_d = sift._grid_tables()
    ns = sift._ORI_GRID * sift._ORI_GRID
    p3_err = p4_err = 0.0
    p3_bytes = p4_bytes = tables
    p3_ops = p4_ops = 0.0
    for o, (a, d) in enumerate(zip(ori_calls, desc_calls)):
        gxp, gyp, ucx, ucy, scl = a
        f, q, py, px = gxp.shape
        h = sift.orientation_hist(*a)
        hk, vx_k, vy_k, bins_k = sift.orientation_hist(*a, detail=True)
        ok, info = p3_judge(hk, bins_k, p3_references(*a))
        serial = int((hk.view(torch.int32) != p3_serial(
            vx_k, vy_k, bins_k).view(torch.int32)).sum())
        fh, qh = f // 2, q // 2
        split_f = torch.equal(torch.cat([sift.orientation_hist(
            *(x[:fh] for x in a)), sift.orientation_hist(
            *(x[fh:] for x in a))]), h)
        split_q = torch.equal(torch.cat([sift.orientation_hist(
            *(x[:, :qh] for x in a)), sift.orientation_hist(
            *(x[:, qh:] for x in a))], 1), h)
        p3_err = max(p3_err, float((h - sift.orientation_hist_plain(*a))
                                   .abs().max()))
        check(f"P3 sift_orientation_hist (octave {o}, {f} x {q} slots of "
              f"{py}x{px} patches)",
              ok and torch.equal(h, hk) and split_f and split_q
              and serial == 0,
              f"{info}; bins whose bits differ from p3_serial of the "
              f"kernel's own samples and bins: {serial} (want 0); relative "
              f"to the bins' terms' magnitudes: kernel "
              f"against float64 {info['rel_kernel_f64']:.3e} (<= 1e-6), "
              f"against plain {info['rel_kernel_plain']:.3e}; slots where a "
              f"sample's bin differs: {info['flipped_plain']} against the "
              f"plain (<= {info['cap']}, 1 per 1000), {info['flipped_f64']} "
              f"against float64, each within its moved samples' "
              f"magnitudes={info['flipped_within_bound']}; detail mode equal="
              f"{bool(torch.equal(h, hk))}; bit-equal split frames "
              f"{fh} + {f - fh}={split_f}, slots {qh} + {q - qh}={split_q}")
        rad = scl * 4.5
        n_px = _sampled_px(torch, ucx, ucy, rad, lin_o, py, px)
        p3_bytes += int(n_px.sum()) * 8 + f * q * (3 + 36) * 4
        p3_ops += f * q * ns * P3_OPS_PER_SAMPLE

        gxp, gyp, pidx, sx, sy, ss, theta = d
        qd = pidx.shape[1]
        k = sift.descriptor(*d)
        kd = sift.descriptor(*d, detail=True)[0]
        plain = sift.descriptor_plain(sift._take(gxp, pidx),
                                      sift._take(gyp, pidx), sx, sy, ss,
                                      theta)
        f64 = sift.descriptor_plain(
            sift._take(gxp.double(), pidx), sift._take(gyp.double(), pidx),
            sx.double(), sy.double(), ss.double(), theta.double())
        ok, e_kp, e_kd, e_pd = p4_judge(k, plain, f64)
        del f64
        split_f = torch.equal(torch.cat([sift.descriptor(
            *(x[:fh] for x in d)), sift.descriptor(*(x[fh:] for x in d))]), k)
        qh = qd // 2
        split_q = torch.equal(torch.cat([sift.descriptor(
            gxp, gyp, *(x[:, :qh] for x in d[2:])), sift.descriptor(
            gxp, gyp, *(x[:, qh:] for x in d[2:]))], 1), k)
        p4_err = max(p4_err, e_kp)
        check(f"P4 sift_descriptor (octave {o}, {f} x {qd} slots of "
              f"{py}x{px} patches)",
              ok and torch.equal(k, kd) and split_f and split_q,
              f"max |kernel - plain| {e_kp:.3e}, |kernel - float64| "
              f"{e_kd:.3e} (each <= 1e-5 on every slot), |plain - float64| "
              f"{e_pd:.3e}; detail mode equal={bool(torch.equal(k, kd))}; "
              f"bit-equal split frames {fh} + {f - fh}={split_f}, slots "
              f"{qh} + {qd - qh}={split_q}")
        # a source patch (a keypoint and its secondary orientation) counts
        # once: both read the same pixels
        src, inv = torch.unique(torch.arange(f, device=dev)[:, None] * q
                                + pidx, return_inverse=True)
        rad = ss * 3.0 * math.sqrt(2.0) * 5 * 0.5
        n_px = _sampled_px(torch, sx, sy, rad, lin_d, py, px).reshape(-1)
        once = torch.zeros(src.numel(), dtype=n_px.dtype, device=dev)
        once.scatter_(0, inv.reshape(-1), n_px)
        p4_bytes += int(once.sum()) * 8 + f * qd * (4 * 4 + 8 + 128 * 4)
        p4_ops += f * qd * (ns * P4_OPS_PER_SAMPLE + P4_OPS_PER_SLOT)

    rows = {}
    for name, calls, kern, plain_fn, err, nbytes, ops, frag, line in (
            ("sift_orientation_hist", ori_calls, sift.orientation_hist,
             sift.orientation_hist_plain, p3_err, p3_bytes, p3_ops,
             "ori_hist_kernel", 421),
            ("sift_descriptor", desc_calls, sift.descriptor,
             lambda g, gy, i, *r: sift.descriptor_plain(
                 sift._take(g, i), sift._take(gy, i), *r),
             p4_err, p4_bytes, p4_ops, "desc_kernel", 502)):
        def run(calls=calls, kern=kern):
            return [kern(*a) for a in calls]

        b_ms, b_by = t["bound"](nbytes, ops, FP32_OPS_PER_S)
        rows[name] = dict(
            name=name, route="cuda",
            source="rpe_tpu_torch/csrc/sift_sample.cu",
            # port-only: no Pallas kernel; the reference's XLA code
            replaces=f"rpe_tpu/ops/sift.py:{line}", max_abs_err=err,
            ms=t["cuda_ms"](run),
            plain_ms=t["cuda_ms"](lambda calls=calls, fn=plain_fn:
                                  [fn(*a) for a in calls], iters=3),
            bound_ms=b_ms, bound_by=b_by, library_ms=None)
        t["queued"][name] = t["queued_ms"](run)
        t["device"][name] = t["device_ms"](run, frag)
        first, last = calls[0], calls[-1]
        say(f"{name}: octave 0 {tuple(first[0].shape)} "
            f"{t['cuda_ms'](lambda: kern(*first)):.4f} ms, last octave "
            f"{tuple(last[0].shape)} {t['cuda_ms'](lambda: kern(*last)):.4f}"
            f" ms (flushed); bytes read and written once {nbytes} (the "
            f"sampled pixels of each source patch, {card})")
    return rows


def _calibration_line(np, check):
    """`tools.calibrate.calibrate_with_filtering` on 12 seeded views of a
    7x7 board (K fx 800, fy 790, k1 -0.08, k2 0.02, 0.05 px noise), views 3
    and 7 moved by 8 px noise: those two dropped, K within 1.5%."""
    from rpe_tpu_torch.geometry.vp_refine import _so3_exp_np
    from rpe_tpu_torch.tools.calibrate import calibrate_with_filtering, \
        make_object_points, project

    g = np.random.default_rng(7)
    K = np.array([[800.0, 0, 480.0], [0, 790.0, 360.0], [0, 0, 1.0]])
    obj = make_object_points(7, 7, 0.04)
    objs, imgs = [], []
    for v in range(12):
        rvec = g.normal(size=3) * 0.35
        tvec = np.array([g.uniform(-0.1, 0.1), g.uniform(-0.1, 0.1),
                         g.uniform(0.5, 1.0)])
        tvec[:2] -= (_so3_exp_np(rvec) @ obj.mean(0))[:2]
        pts = project(obj, K, np.array([-0.08, 0.02]), rvec, tvec)
        objs.append(obj)
        imgs.append(pts + g.normal(size=pts.shape)
                    * (8.0 if v in (3, 7) else 0.05))
    t0 = time.perf_counter()
    rms, Kc, dist, errs, keep = calibrate_with_filtering(
        objs, imgs, (960, 720), error_threshold=1.0, min_keep=5)
    dt = time.perf_counter() - t0
    fx_err = abs(Kc[0, 0] / K[0, 0] - 1)
    check("calibration (host)", not keep[3] and not keep[7]
          and keep.sum() == 10 and fx_err < 0.015 and rms < 0.3,
          f"kept {int(keep.sum())}/12 views (3 and 7 dropped="
          f"{not keep[3] and not keep[7]}), rms {rms:.4f} px, fx "
          f"{Kc[0, 0]:.3f} fy {Kc[1, 1]:.3f} (truth 800, 790), k1 "
          f"{dist[0]:.4f}, {dt:.2f} s on the host")
    return dict(rms=rms, kept=int(keep.sum()), fx=float(Kc[0, 0]),
                fy=float(Kc[1, 1]), seconds=dt)


def _ckpt_records(path):
    """A checkpoint's records after its header, in file order."""
    return [json.loads(x) for x in Path(path).read_text().splitlines()[1:]]


def _pair_rotations(np, recs, n):
    last = {r["pair"]: r for r in recs}
    return np.array([np.reshape(last[i]["R"], (3, 3)) for i in range(n)]), \
        [last[i]["valid"] for i in range(n)]


def _union_ms(spans):
    """Length in ms of the union of (start_us, end_us) spans."""
    total, end = 0.0, -1.0
    for a, b in sorted(spans):
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1e3


def _overlap_ms(spans, a, b):
    return _union_ms([(max(s, a), min(e, b)) for s, e in spans
                      if e > a and s < b])


def _run_runner(argv, device=None, tag="[runner]"):
    """`run_kitti_sequence.main(argv)` with its output echoed under `tag`;
    returns (summary, printed text)."""
    import io

    from rpe_tpu_torch.cli import run_kitti_sequence as runner

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = runner.main(argv, device=device)
    text = buf.getvalue()
    for line in text.splitlines():
        if line.strip():
            say(f"{tag} | {line}")
    return out, text


def _runner_phase(torch, np, card, check, tmp, keep):
    """Phase 5 (module docstring): the KITTI sequence runner from PNGs
    written under `tmp`. Returns the numbers it printed; `keep` receives
    what phase 7 reuses (the runner's arguments, K, the per-pair rotations
    and `valid`, the summary)."""
    import io
    import re

    from torch.profiler import ProfilerActivity, profile

    from rpe_tpu_torch.config import EstimatorConfig, MatcherConfig, \
        OrbConfig, RansacConfig
    from rpe_tpu_torch.io import image_loader
    from rpe_tpu_torch.io.image_loader import LazyFrameSource
    from rpe_tpu_torch.ops import kernels
    from rpe_tpu_torch.pipeline.batch import FALLBACK_BATCH, BatchProcessor
    from rpe_tpu_torch.pipeline.estimator import PoseEstimator
    from rpe_tpu_torch.utils.synthetic import make_sequence, \
        rotation_error_deg, write_kitti_sequence

    t_phase = time.perf_counter()
    n_pairs = SEQ_FRAMES - 1
    n_chunks = -(-n_pairs // SEQ_CHUNK)
    main_path = ("fast_harris", "extract_brief", "match_hamming",
                 "five_point_roots")
    res = {}

    t0 = time.perf_counter()
    frames, K, (R_gt, t_gt) = make_sequence(
        SEQ_FRAMES, H, W, seed=0, step=SEQ_STEP, rot_deg=SEQ_ROT_DEG)
    images, poses, calib = write_kitti_sequence(tmp, frames, K, R_gt,
                                                t_gt)
    say(f"[runner] wrote {SEQ_FRAMES} frames of {W}x{H} as PNGs, "
        f"poses.txt and calib.txt in {time.perf_counter() - t0:.1f} s")
    base = ["--images-dir", str(images), "--poses", str(poses),
            "--calib", str(calib), "--chunk", str(SEQ_CHUNK)]

    # the runner on the card, with a checkpoint
    ckpt = tmp / "card.jsonl"
    torch.cuda.synchronize()
    image_loader.reset_decodes()
    kernels.reset_launches()
    t0 = time.perf_counter()
    out, text = _run_runner(base + ["--checkpoint", str(ckpt),
                                    "--results-dir", str(tmp / "card")])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
    decodes = dict(image_loader.DECODES)
    want = ({k: n_chunks for k in main_path}
            | kernels.geometry_launches(n_chunks))
    check("[runner] launches", launches == want,
          f"{launches} (want K1-K4 and P1 once per chunk of {SEQ_CHUNK} "
          f"pairs, P2 {kernels.P2_PER_CALL} times, {want}, and no other "
          f"kernel)")
    check("[runner] native decodes",
          decodes == {"native": SEQ_FRAMES, "pil": 0},
          f"{decodes} (want all {SEQ_FRAMES} frames by the native "
          f"decoder)")
    R_est, valid = _pair_rotations(np, _ckpt_records(ckpt), n_pairs)
    check("[runner] every pair valid",
          out["n_pairs_valid"] == n_pairs and all(valid),
          f"{out['n_pairs_valid']} of {n_pairs} valid")
    rot = rotation_error_deg(R_est, R_gt[None])
    check("[runner] rotation vs the scene", rot.max() < SEQ_ROT_GT_DEG,
          f"max {rot.max():.4f} deg, mean {rot.mean():.4f} (< "
          f"{SEQ_ROT_GT_DEG})")
    ate, rpe_t, rpe_r = (out["ate_sim3"]["rmse"], out["rpe_trans"]["rmse"],
                         out["rpe_rot_deg"]["rmse"])
    check("[runner] ATE/RPE vs poses.txt",
          ate < SEQ_ATE_SIM3 and rpe_t < SEQ_RPE_TRANS
          and rpe_r < SEQ_RPE_ROT_DEG,
          f"ATE sim3 RMSE {ate:.4f} (< {SEQ_ATE_SIM3}), se3 "
          f"{out['ate_se3']['rmse']:.4f}; RPE trans RMSE {rpe_t:.4f} (< "
          f"{SEQ_RPE_TRANS}), rot RMSE {rpe_r:.4f} deg (< "
          f"{SEQ_RPE_ROT_DEG}); in steps of one frame")
    m = re.search(r"Throughput: ([\d.]+) pairs/sec/chip", text)
    stages = {k: (float(ms), int(n)) for k, ms, n in re.findall(
        r"stage (\w+): ([\d.]+) ms x (\d+)", text)}
    pps = float(m.group(1)) if m else float("nan")
    check("[runner] throughput line", m is not None,
          "the runner printed its ThroughputMeter line")
    say(f"[runner] throughput (ThroughputMeter, first decode to last "
        f"flush): {pps} pairs/s over {n_pairs} pairs at chunk "
        f"{SEQ_CHUNK}, {W}x{H}; whole runner {wall:.3f} s ({card})")
    say(f"[runner] stages, mean ms x count: {stages} ({card})")
    res.update(pairs_per_s=pps, runner_s=wall, stages_ms=stages, launches=launches,
               rot_err_gt_deg=[float(x) for x in rot],
               ate_sim3=ate, ate_se3=out["ate_se3"]["rmse"],
               rpe_trans=rpe_t, rpe_rot_deg=rpe_r)
    keep.update(base=base, K=K, R=R_est, valid=valid, out=out,
                images=images, R_gt=R_gt)

    # the same runner with device="cpu" on frames 0-3
    t0 = time.perf_counter()
    cout, _ = _run_runner(base + ["--max-frames", "4", "--checkpoint",
                                  str(tmp / "cpu.jsonl"), "--results-dir",
                                  str(tmp / "cpu")], device="cpu")
    R_cpu, v_cpu = _pair_rotations(np, _ckpt_records(tmp / "cpu.jsonl"),
                                   3)
    d_rot = rotation_error_deg(R_est[:3], R_cpu)
    check("[runner] CUDA vs CPU (frames 0-3)",
          v_cpu == valid[:3] and bool((d_rot <= 0.5).all()),
          f"valid cuda {valid[:3]} cpu {v_cpu}, rotation difference "
          f"(deg) {[float(x) for x in d_rot]} (<= 0.5); CPU run "
          f"{time.perf_counter() - t0:.1f} s")

    # resume from the checkpoint: nothing launched, identical outputs
    kernels.reset_launches()
    rout, rtext = _run_runner(base + ["--checkpoint", str(ckpt),
                                      "--results-dir", str(tmp / "resume")])
    torch.cuda.synchronize()
    ran = {k: n for k, n in kernels.LAUNCHES.items() if n}
    same = all((tmp / "card" / f).read_bytes()
               == (tmp / "resume" / f).read_bytes()
               for f in ("est_poses_kitti.txt",
                         "trajectory_summary.json"))
    check("[runner] resume", not ran and rout == out and same
          and f"Resumed {n_pairs} pairs" in rtext,
          f"launches {ran} (want none), outputs identical={same}, "
          f"summary equal={rout == out}")

    # the inlier-collapse fallback on the card (tests/test_fallback.py)
    weak = EstimatorConfig(
        orb=OrbConfig(nfeatures=128, nlevels=2, max_kpts=128, band=8,
                      extract_cap=8),
        matcher=MatcherConfig(max_matches=64),
        ransac=RansacConfig(num_hypotheses=64),
        fallback_profile="orb512", fallback_min_inliers=10 ** 5)
    paths = sorted(images.glob("*.png"))
    proc = BatchProcessor(
        images, PoseEstimator(K, nfeatures=128, max_matches=64,
                              config=weak),
        None, chunk=SEQ_CHUNK, checkpoint_path=tmp / "fallback.jsonl")
    kernels.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        proc.estimate_relative_poses(list(range(SEQ_FRAMES)),
                                     LazyFrameSource(paths))
    torch.cuda.synchronize()
    ftext = buf.getvalue()
    fl = {k: n for k, n in kernels.LAUNCHES.items() if n}
    n_fb = -(-n_pairs // FALLBACK_BATCH)
    want_fb = ({k: n_chunks + n_fb for k in main_path}
               | kernels.geometry_launches(n_chunks + n_fb))
    recs = _ckpt_records(tmp / "fallback.jsonl")
    first = {r["pair"]: r for r in recs[:n_pairs]}
    final = {r["pair"]: r for r in recs[n_pairs:]}
    adopted = [i for i in final if final[i] != first[i]]
    healthier = all(final[i]["valid"] and final[i]["num_inliers"]
                    > first[i]["num_inliers"] for i in adopted)
    check("[runner] fallback on the card",
          f"Fallback: re-running {n_pairs} collapsed pair(s) at profile "
          f"orb512" in ftext and fl == want_fb and len(adopted) > 0
          and healthier,
          f"launches {fl} (want {want_fb}: {n_chunks} chunks, then "
          f"{n_fb} orb512 batches of {FALLBACK_BATCH} pairs), "
          f"{len(adopted)} of {n_pairs} pairs adopted, each with more "
          f"inliers={healthier}; inliers before "
          f"{[first[i]['num_inliers'] for i in sorted(first)]} after "
          f"{[final[i]['num_inliers'] for i in sorted(final)]}")

    # when did the card finish each chunk, against the host's decode of
    # the next? An event recorded after each dispatch, on the host's
    # clock through an event taken on the idle card; no profiler.
    import rpe_tpu_torch.pipeline.batch as batch_mod

    done, decodes_at = [], []

    class TimedSource(LazyFrameSource):
        def get(self, indices):
            a = time.perf_counter()
            out = super().get(indices)
            decodes_at.append((a, time.perf_counter()))
            return out

    def timed(*a, **k):
        out = dispatch(*a, **k)
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        done.append((e, time.perf_counter()))
        return out

    proc = BatchProcessor(images, PoseEstimator(K), None,
                          chunk=SEQ_CHUNK)
    dispatch = batch_mod.estimate_sequence_batched
    e0 = torch.cuda.Event(enable_timing=True)
    e0.record()
    torch.cuda.synchronize()
    h0 = time.perf_counter()
    batch_mod.estimate_sequence_batched = timed
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            proc.estimate_relative_poses(list(range(SEQ_FRAMES)),
                                         TimedSource(paths))
    finally:
        batch_mod.estimate_sequence_batched = dispatch
    torch.cuda.synchronize()
    overlap = []
    for c, (e, returned) in enumerate(done[:-1]):
        finished = h0 + e0.elapsed_time(e) / 1e3
        a, b = decodes_at[c + 1]
        o = dict(chunk=c, dispatch_returned_ms=(returned - h0) * 1e3,
                 card_finished_ms=(finished - h0) * 1e3,
                 next_decode_ms=[(a - h0) * 1e3, (b - h0) * 1e3],
                 hidden_ms=max(0.0, min(finished, b) - a) * 1e3)
        overlap.append(o)
        say(f"[runner] chunk {c}: dispatch returned at "
            f"{o['dispatch_returned_ms']:.3f} ms, the card finished it at "
            f"{o['card_finished_ms']:.3f} ms; decode of chunk {c + 1} "
            f"{o['next_decode_ms'][0]:.3f}-{o['next_decode_ms'][1]:.3f} "
            f"ms, {o['hidden_ms']:.3f} ms of it beside the card's work "
            f"(ms from the loop's start; {card})")
    res["overlap"] = overlap

    # one trace of the pair loop: the card's busy share
    proc = BatchProcessor(images, PoseEstimator(K), None,
                          chunk=SEQ_CHUNK)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with contextlib.redirect_stdout(io.StringIO()):
            proc.estimate_relative_poses(list(range(SEQ_FRAMES)),
                                         LazyFrameSource(paths))
        torch.cuda.synchronize()
    evs = prof.events()

    def on_card(e):
        return str(getattr(e, "device_type", "")).endswith("CUDA")

    # device work only: kernels, copies and memsets, not the stage ranges
    # (StageTimer's spans, host events; their names are left out in case a
    # profiler shows them on the device's timeline)
    stages = ("decode", "stage", "dispatch", "flush")
    dev_spans = [(e.time_range.start, e.time_range.end) for e in evs
                 if on_card(e) and e.name not in stages]
    host = [(e.time_range.start, e.time_range.end) for e in evs
            if e.name in stages and not on_card(e)]
    loop = (min(a for a, _ in host), max(b for _, b in host))
    busy = _overlap_ms(dev_spans, *loop)
    loop_ms = (loop[1] - loop[0]) / 1e3
    say(f"[runner] trace: pair loop {loop_ms:.1f} ms (profiled), device "
        f"busy {busy:.1f} ms of it ({100 * busy / loop_ms:.1f}%), "
        f"{len(dev_spans)} device events ({card})")
    # host calls that wait for the card (a copy from pageable host
    # memory waits for the stream before it starts), and the device
    # time by kernel
    waits = {}
    for e in evs:
        if e.name.startswith(("cudaStreamSynchronize",
                              "cudaDeviceSynchronize", "cudaMemcpy",
                              "cudaEventSynchronize")):
            waits[e.name] = waits.get(e.name, 0) + 1
    say(f"[runner] trace: host runtime calls that can wait for the card: "
        f"{waits}")
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=20)
    (OUT_DIR / "profile_runner.txt").write_text(table)
    for line in table.splitlines()[:14]:
        say(f"[runner] profile| {line}")
    res.update(trace_loop_ms=loop_ms, trace_device_busy_ms=busy,
               trace_waits=waits)
    res["phase_s"] = time.perf_counter() - t_phase
    say(f"[runner] phase: {res['phase_s']:.1f} s")
    return res


def _vp_phase(torch, np, card, check, phase5, room):
    """Phase 6 (module docstring): VP refinement through the simulator
    runner, both twins, the CPU cross-check, the single-pair entry points
    and the VP stage's times; the room's frames are written under `room`
    (phase 8 runs them again). Returns the numbers it printed."""
    import io

    from torch.profiler import ProfilerActivity, profile

    from rpe_tpu_torch.cli import run_simulator_data, run_single_pair
    from rpe_tpu_torch.config import VpConfig
    from rpe_tpu_torch.geometry import vp_refine
    from rpe_tpu_torch.io.image_loader import load_image
    from rpe_tpu_torch.ops import kernels, lsd
    from rpe_tpu_torch.pipeline.batch import BatchProcessor
    from rpe_tpu_torch.pipeline.estimator import PoseEstimator
    from rpe_tpu_torch.pipeline.calibration import CameraCalibration
    from rpe_tpu_torch.utils.synthetic import GATED_ROOM, \
        manhattan_sequence, rot_y, rotation_error_deg, write_dataset

    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    main_path = ("fast_harris", "extract_brief", "match_hamming",
                 "five_point_roots")
    cfg = VpConfig(enabled=True)
    res = {}

    def reliable(entry):
        _, ok, dbg = entry
        return bool(ok and dbg.get("acc_max", 0.0) >= cfg.acc_min
                    and dbg.get("vp2_score", 0.0) >= cfg.vp2_min)

    # each run's BatchProcessor, its VP stats and its sequence wall time
    procs = []
    process_sequence = BatchProcessor.process_sequence

    def keep(self, frame_indices):
        t0 = time.perf_counter()
        out = process_sequence(self, frame_indices)
        if self.pose_estimator.device.type == "cuda":
            torch.cuda.synchronize()
        procs.append((self, time.perf_counter() - t0))
        return out

    def run(main, argv, device=None, env=None):
        old = {k: os.environ.get(k) for k in (env or {})}
        os.environ.update(env or {})
        buf = io.StringIO()
        try:
            with contextlib.redirect_stdout(buf):
                out = main(argv, device=device)
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        text = buf.getvalue()
        for line in text.splitlines():
            if line.strip() and ("[INFO] VP" in line or "Throughput" in line
                                 or "Mean:" in line or "Max:" in line):
                say(f"[vp] | {line}")
        return out, text

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        # drawn through the intrinsics the simulator runner assumes (no
        # calibration file: the base intrinsics scaled to the frame size)
        frames, K, S, yaw, centres = manhattan_sequence(
            VP_FRAMES, H, W, seed=0,
            K=CameraCalibration().get_matrix(W, H), **GATED_ROOM)
        data = room / "evaluation-runs/simulator-data/data"
        write_dataset(data, frames, yaw, centres)
        small = tmp / "cpu"
        write_dataset(small / "evaluation-runs/simulator-data/data",
                      frames[:4], yaw[:4], centres[:4])
        say(f"[vp] wrote a Manhattan room of {VP_FRAMES} frames of {W}x{H} "
            f"in the simulator layout in {time.perf_counter() - t0:.1f} s")
        argv = ["--step", "1", "--chunk", str(VP_CHUNK), "--no-video"]
        BatchProcessor.process_sequence = keep
        dirs = vp_refine._dirs_from_lines_device
        votes = [0]

        def counted_dirs(*a, **k):
            votes[0] += 1
            return dirs(*a, **k)

        vp_refine._dirs_from_lines_device = counted_dirs
        try:
            runs = {}
            for twin, env in (("host", None), ("device", {"RPE_VP_DEVICE":
                                                          "1"})):
                torch.cuda.synchronize()
                kernels.reset_launches()
                votes[0] = 0
                out, text = run(run_simulator_data.main,
                                ["--data-root", str(room), "--results-dir",
                                 str(tmp / twin)] + argv, env=env)
                torch.cuda.synchronize()
                launches = {k: n for k, n in kernels.LAUNCHES.items() if n}
                proc, wall = procs[-1]
                runs[twin] = out, text, proc, wall, launches, votes[0]
            cout, _ = run(run_simulator_data.main,
                          ["--data-root", str(small), "--results-dir",
                           str(tmp / "cpu_out")] + argv, device="cpu")
            cproc = procs[-1][0]
        finally:
            BatchProcessor.process_sequence = process_sequence
            vp_refine._dirs_from_lines_device = dirs

        n_pairs = VP_FRAMES - 1
        for twin, (out, text, proc, wall, launches, n_votes) in runs.items():
            # the device twin's vote draws its pairs on the card: a split
            # and two randint (a split and two draws each), 7 hashes (P8)
            want = {k: 1 for k in main_path} | kernels.geometry_launches(1)
            want["threefry2x32"] += 7 * n_votes
            est, ev = out["estimated"], out["evaluation"]
            check(f"[vp {twin}] launches", launches == want,
                  f"{launches} (want K1-K4 and P1 once for the one chunk of "
                  f"{VP_CHUNK} pairs, P2 {kernels.P2_PER_CALL} times, P5-P8 "
                  f"as the path makes them, P8 7 times more for each of "
                  f"the device twin's {n_votes} votes, and no other "
                  f"kernel)")
            check(f"[vp {twin}] every pair valid", bool(est["valid"].all())
                  and len(est["valid"]) == n_pairs,
                  f"{int(est['valid'].sum())} of {n_pairs} valid")
            acc = [e[2].get("acc_max", 0.0) for e in proc.vp_frames]
            vp2 = [e[2].get("vp2_score", 0.0) for e in proc.vp_frames]
            gates = [reliable(e) for e in proc.vp_frames]
            check(f"[vp {twin}] default gates pass on every frame",
                  len(gates) == VP_FRAMES and all(gates),
                  f"{sum(gates)} of {VP_FRAMES} frames reliable; lowest "
                  f"acc_max {min(acc):.1f} (>= {cfg.acc_min}), lowest "
                  f"vp2_score {min(vp2):.1f} (>= {cfg.vp2_min})")
            say(f"[vp {twin}] acc_max per frame: "
                f"{[round(a, 1) for a in acc]}")
            say(f"[vp {twin}] vp2_score per frame: "
                f"{[round(v, 1) for v in vp2]}")
            used = int(proc.vp_used.sum())
            say(f"[vp {twin}] VP refinement used on {used} of {n_pairs} "
                f"pairs: {proc.vp_used.astype(int).tolist()}")
            rot = np.asarray(ev["rotation_error"])
            check(f"[vp {twin}] rotation vs the scene",
                  bool(rot.max() < VP_ROT_GT_DEG),
                  f"max {rot.max():.4f} deg, mean {rot.mean():.4f} (< "
                  f"{VP_ROT_GT_DEG})")
            csv_path = tmp / twin / "evaluation_results.csv"
            lines = csv_path.read_text().splitlines()
            check(f"[vp {twin}] artifacts",
                  len(lines) == n_pairs + 1
                  and len(lines[0].split(",")) == 12
                  and (tmp / twin / "orientation_plot.html").is_file(),
                  f"evaluation_results.csv {len(lines) - 1} rows x "
                  f"{len(lines[0].split(','))} columns, "
                  f"orientation_plot.html written")
            vp_ms = proc.timer.totals.get("vp", 0.0) * 1e3
            say(f"[vp {twin}] process_sequence {wall * 1e3:.1f} ms "
                f"(synchronised), {n_pairs / wall:.3f} pairs/s with VP; VP "
                f"stage {vp_ms:.1f} ms in {proc.timer.counts.get('vp', 0)} "
                f"blocks of 8 frames ({100 * vp_ms / (wall * 1e3):.1f}% of "
                f"the sequence; {card})")
            res[twin] = dict(
                launches=launches, used=proc.vp_used.tolist(),
                acc_max=acc, vp2_score=vp2, rot_err_gt_deg=rot.tolist(),
                pairs_per_s=n_pairs / wall, sequence_ms=wall * 1e3,
                vp_ms=vp_ms)
        host_p, dev_p = runs["host"][2], runs["device"][2]
        g_host = [reliable(e) for e in host_p.vp_frames]
        g_dev = [reliable(e) for e in dev_p.vp_frames]
        check("[vp] device twin against host twin", g_host == g_dev,
              f"per-frame gate decisions host {g_host} device {g_dev}")
        say(f"[vp] host-twin pairs/s with VP {res['host']['pairs_per_s']:.3f}"
            f", phase 5's runner without VP {phase5['pairs_per_s']} (its "
            f"ThroughputMeter; {card})")

        # the CPU on frames 0-3
        c_est = cout["estimated"]
        h_est = runs["host"][0]["estimated"]
        d_rot = rotation_error_deg(np.stack(h_est["R"][:3]),
                                   np.stack(c_est["R"]))
        g_cpu = [reliable(e) for e in cproc.vp_frames]
        check("[vp] CUDA vs CPU (frames 0-3)",
              bool((c_est["valid"] == h_est["valid"][:3]).all())
              and g_cpu == g_host[:4]
              and cproc.vp_used.tolist() == host_p.vp_used[:3].tolist()
              and bool((d_rot <= 0.5).all()),
              f"valid cuda {h_est['valid'][:3].tolist()} cpu "
              f"{c_est['valid'].tolist()}, gates cuda {g_host[:4]} cpu "
              f"{g_cpu}, vp_used cuda {host_p.vp_used[:3].tolist()} cpu "
              f"{cproc.vp_used.tolist()}, rotation difference (deg) "
              f"{[float(x) for x in d_rot]} (<= 0.5)")
        g0 = torch.from_numpy(np.clip(np.rint(frames[0]), 0, 255)
                              .astype(np.float32))
        lab_card = lsd._label_regions(g0.to(dev))[0].cpu()
        lab_cpu = lsd._label_regions(g0)[0]
        differ = int((lab_card != lab_cpu).sum())
        say(f"[vp] labels of frame 0: {differ} of {lab_cpu.numel()} pixels "
            f"differ between the card and the CPU "
            f"({differ / lab_cpu.numel():.8f})")
        res["label_differ_px"] = differ
        res["label_px"] = lab_cpu.numel()

        # the single-pair entry points
        images = data / "images"
        (R1, t1), _ = run(run_single_pair.main,
                          ["--img1", str(images / "000000.png"), "--img2",
                           str(images / "000001.png")])
        check("[vp] run_single_pair on the card",
              R1.shape == (3, 3) and bool(np.isfinite(R1).all())
              and t1.shape == (3, 1),
              f"R error vs the scene {rotation_error_deg(R1, S):.4f} deg "
              f"(VP on, no R_prev: the plain pose)")
        img1 = load_image(str(images / "000004.png"))
        img2 = load_image(str(images / "000005.png"))
        R_prev = rot_y(float(yaw[4]))
        plain, outs = {}, {}
        for d in ("cuda", "cpu"):
            plain[d] = PoseEstimator(K, use_vp_refinement=True, device=d) \
                .estimate_with_debug(img1, img2)
            outs[d] = PoseEstimator(K, use_vp_refinement=True, device=d) \
                .estimate_with_debug(img1, img2, R_prev)
        # the host twin's LM (the reference's, 12 steps) does not contract
        # two nearby starts onto one point, so the card's and the CPU's
        # refined R differ by about as much as their plain poses do; with
        # the same start, VP on the card gives the CPU's R
        d_plain = float(np.radians(rotation_error_deg(plain["cuda"]["R"],
                                                      plain["cpu"]["R"])))
        d_ref = float(np.radians(rotation_error_deg(outs["cuda"]["R"],
                                                    outs["cpu"]["R"])))
        stats = {d: [(o["vp_debug"][r].get("acc_max", 0.0),
                      o["vp_debug"][r].get("vp2_score", 0.0))
                     for r in ("prev_frame", "new_frame")]
                 for d, o in outs.items()}
        cost = {d: o["vp_debug"].get("optimization", {}).get(
            "cost_opt", float("nan")) for d, o in outs.items()}
        same_stats = np.allclose(stats["cuda"], stats["cpu"], rtol=1e-9,
                                 atol=0)
        check("[vp] PoseEstimator with R_prev, card vs CPU",
              outs["cuda"]["vp_used"] == outs["cpu"]["vp_used"]
              and same_stats and d_ref <= d_plain + 1e-4,
              f"vp_used card {outs['cuda']['vp_used']} cpu "
              f"{outs['cpu']['vp_used']}; VP statistics (acc_max, "
              f"vp2_score per role) card {stats['cuda']} cpu "
              f"{stats['cpu']}; refined R difference {d_ref:.3e} rad, "
              f"plain poses' {d_plain:.3e} rad (refined <= plain + 1e-4); "
              f"cost_opt card {cost['cuda']:.3e} cpu {cost['cpu']:.3e}")
        R_rel = plain["cpu"]["R"]
        same = {d: vp_refine.refine_rotation_with_vps(
            img1, img2, R_prev, R_rel, K, cfg, device=d) for d in
            ("cuda", "cpu")}
        d_same = float(np.radians(rotation_error_deg(same["cuda"][0],
                                                     same["cpu"][0])))
        check("[vp] refine_rotation_with_vps, card vs CPU, same start",
              same["cuda"][1] == same["cpu"][1] and d_same < 1e-4,
              f"used card {same['cuda'][1]} cpu {same['cpu'][1]}, R "
              f"difference {d_same:.3e} rad (< 1e-4)")
        res.update(pose_estimator_d_refined_rad=d_ref,
                   pose_estimator_d_plain_rad=d_plain,
                   refine_same_start_d_rad=d_same)

        # times of the VP stage per block of 8 frames
        blk_np = np.clip(np.rint(frames[:8]), 0, 255).astype(np.float32)
        blk = torch.from_numpy(blk_np).to(dev)
        K64 = K.astype(np.float64)

        def events_ms(fn, reps=5):
            fn()
            torch.cuda.synchronize()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(reps):
                fn()
            e.record()
            torch.cuda.synchronize()
            return s.elapsed_time(e) / reps

        def host_ms(fn, reps=3):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / reps * 1e3

        label_ms = events_ms(lambda: lsd._label_regions(blk))
        labels, mags = lsd.label_regions_host(blk_np, device=dev)

        def voting():
            for f in range(8):
                vp_refine._dirs_from_lines(
                    lsd.segments_from_labels(labels[f], mags[f]), K64, cfg,
                    rng_seed=f)

        seg_ms = host_ms(voting)
        host_twin_ms = host_ms(lambda: vp_refine.manhattan_dirs_for_frames(
            blk_np, K64, cfg, device=dev))
        dev_twin_ms = host_ms(
            lambda: vp_refine.manhattan_dirs_for_frames_device(
                blk_np, K64, cfg, device=dev))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lsd._label_regions(blk)
            torch.cuda.synchronize()
        n_dev = sum(1 for e in prof.events()
                    if str(getattr(e, "device_type", "")).endswith("CUDA"))
        say(f"[vp] one block of 8 frames of {W}x{H}: labeling "
            f"{label_ms:.3f} ms (CUDA events, {lsd.PROP_ITERS} rounds), "
            f"{n_dev} device events in the labeling (torch.profiler); host "
            f"segments + voting {seg_ms:.1f} ms; host twin end to end "
            f"{host_twin_ms:.1f} ms; device twin end to end "
            f"{dev_twin_ms:.1f} ms (host clock, synchronised; {card})")
        res.update(label_block_ms=label_ms, label_device_events=n_dev,
                   host_segments_voting_ms=seg_ms,
                   host_twin_block_ms=host_twin_ms,
                   device_twin_block_ms=dev_twin_ms)
    res["phase_s"] = time.perf_counter() - t_phase
    say(f"[vp] phase: {res['phase_s']:.1f} s")
    return res

def _mesh_phase(torch, np, card, check, tmp, phase5, p5res, chunk_inputs):
    """Phase 7 (module docstring): the multi-device layer on meshes of the
    one card, against the same work without a mesh. Returns the numbers it
    printed."""
    import io
    import re
    import socket

    import torch.distributed as dist

    from rpe_tpu_torch.io.image_loader import LazyFrameSource
    from rpe_tpu_torch.ops import kernels
    from rpe_tpu_torch.parallel import sharded_error_stats
    from rpe_tpu_torch.parallel.mesh import Mesh
    from rpe_tpu_torch.parallel.multihost import global_pairs_mesh, \
        initialize_distributed
    from rpe_tpu_torch.parallel.sharded_estimator import \
        estimate_pairs_2d, estimate_sequence_sharded
    from rpe_tpu_torch.pipeline.batch import BatchProcessor
    from rpe_tpu_torch.pipeline.estimator import PoseEstimator, \
        estimate_pair, estimate_sequence_batched
    from rpe_tpu_torch.utils.synthetic import rotation_error_deg

    t_phase = time.perf_counter()
    n_pairs = SEQ_FRAMES - 1
    n_chunks = -(-n_pairs // SEQ_CHUNK)
    k1_k4 = ("fast_harris", "extract_brief", "match_hamming",
             "five_point_roots")
    twice = Mesh(["cuda:0", "cuda:0"], ("pairs",))
    res = {}

    def launched():
        torch.cuda.synchronize()
        return {k: n for k, n in kernels.LAUNCHES.items() if n}

    # a. the KITTI runner with --devices 1 (make_mesh(1): a mesh of the
    # card), against phase 5's run without a mesh
    kernels.reset_launches()
    t0 = time.perf_counter()
    out, text = _run_runner(phase5["base"] + [
        "--devices", "1", "--checkpoint", str(tmp / "mesh1.jsonl"),
        "--results-dir", str(tmp / "mesh1")], tag="[mesh]")
    wall = time.perf_counter() - t0
    ran = launched()
    want = {k: n_chunks for k in k1_k4} | kernels.geometry_launches(n_chunks)
    R1, v1 = _pair_rotations(np, _ckpt_records(tmp / "mesh1.jsonl"), n_pairs)
    dR = float(np.abs(R1 - phase5["R"]).max())
    ate = (out["ate_sim3"]["rmse"], phase5["out"]["ate_sim3"]["rmse"])
    check("[mesh] runner --devices 1",
          ran == want and v1 == phase5["valid"] and dR <= 1e-5
          and abs(ate[0] - ate[1]) <= 1e-6,
          f"launches {ran} (want K1-K4 and P1 once per chunk, {want}); "
          f"valid equal"
          f"={v1 == phase5['valid']}; max |R - R without a mesh| {dR:.3g} "
          f"(<= 1e-5); ATE sim3 RMSE {ate[0]!r} against {ate[1]!r} "
          f"(within 1e-6)")
    m = re.search(r"Throughput: ([\d.]+) pairs/sec/chip", text)
    res["runner_devices_1"] = dict(
        pairs_per_s=float(m.group(1)) if m else float("nan"), runner_s=wall,
        launches=ran, max_abs_dR=dR)

    # b. BatchProcessor on the card listed twice: K1-K4 and P1 once per
    # shard. Each shard runs 8 pairs where the run without a mesh runs 16;
    # a pair's pose does not depend on its batch (P1, P2), so the mesh is
    # held to chunk 16 without a mesh as tests/test_sharding.py:182-187
    # holds the reference (valid and inliers equal, R within 1e-5, t within
    # 1e-4), and chunk 8 without a mesh to chunk 16 the same way.
    paths = sorted(phase5["images"].glob("*.png"))
    got = {}
    for i, (label, mesh, chunk) in enumerate((
            ("no mesh", None, SEQ_CHUNK),
            ("no mesh, chunk 8", None, SEQ_CHUNK // 2),
            ("[cuda:0, cuda:0]", twice, SEQ_CHUNK))):
        ck = tmp / f"mesh_b{i}.jsonl"
        proc = BatchProcessor(phase5["images"], PoseEstimator(phase5["K"]),
                              None, chunk=chunk, mesh=mesh,
                              checkpoint_path=ck)
        kernels.reset_launches()
        with contextlib.redirect_stdout(io.StringIO()):
            R, t, valid, _ = proc.estimate_relative_poses(
                list(range(SEQ_FRAMES)), LazyFrameSource(paths))
        ran = launched()
        last = {r["pair"]: r for r in _ckpt_records(ck)}
        inl = np.array([last[j]["num_inliers"] for j in range(n_pairs)])
        pps = proc.meter.pairs_per_sec_per_chip() * proc.meter.n_chips
        got[label] = (R, t, valid, inl, ran)
        say(f"[mesh] BatchProcessor, {label}: {pps:.3f} pairs/s over "
            f"{n_pairs} pairs at chunk {chunk} ({proc.meter.n_chips} "
            f"shard(s) on one card; {card}); launches {ran}")
        res[f"batch {label}"] = dict(pairs_per_s=pps, launches=ran)
    base = got["no mesh"]
    want = ({k: 2 * n_chunks for k in k1_k4}
            | kernels.geometry_launches(2 * n_chunks))
    for label in ("[cuda:0, cuda:0]", "no mesh, chunk 8"):
        R, t, valid, inl, ran = got[label]
        dR = np.abs(R - base[0]).max(axis=(1, 2))
        dt = np.abs(t - base[1]).max(axis=1)
        same_v = bool((valid == base[2]).all())
        same_i = bool((inl == base[3]).all())
        moved = [int(j) for j in np.nonzero(dR > 1e-5)[0]]
        mesh_run = label.startswith("[")
        check(f"[mesh] BatchProcessor {label} against chunk 16",
              same_v and same_i and float(dR.max()) <= 1e-5
              and float(dt.max()) <= 1e-4 and (ran == want or not mesh_run),
              (f"launches {ran} (want K1-K4 and P1 once per shard per "
               f"chunk, {want}); " if mesh_run else "")
              + f"valid equal={same_v}, num_inliers equal={same_i}; max "
              f"|dR| {float(dR.max())!r} (<= 1e-5, expected 0.0), max |dt| "
              f"{float(dt.max())!r} (<= 1e-4, expected 0.0); pairs over "
              f"1e-5 in R: {moved}")
        res[f"batch_vs_chunk16 {label}"] = dict(
            max_abs_dR=float(dR.max()), max_abs_dt=float(dt.max()),
            pairs_over_1e5=moved)
    say(f"[mesh] runner pairs/s: phase 5 without a mesh "
        f"{p5res['pairs_per_s']}, --devices 1 "
        f"{res['runner_devices_1']['pairs_per_s']}; BatchProcessor without "
        f"a mesh {res['batch no mesh']['pairs_per_s']:.3f} (chunk 8 "
        f"{res['batch no mesh, chunk 8']['pairs_per_s']:.3f}), on "
        f"[cuda:0, cuda:0] {res['batch [cuda:0, cuda:0]']['pairs_per_s']:.3f}"
        f" ({card})")

    # c. estimate_sequence_sharded on [cuda:0, cuda:0] over phase 4's 9
    # frames (two blocks of 4 pairs) against estimate_sequence_batched
    frames, K, keys_np, cfg = chunk_inputs
    flat = estimate_sequence_batched(frames, K, keys_np, cfg)
    blocks = np.stack([np.arange(d * 4, d * 4 + 5) for d in range(2)])
    kernels.reset_launches()
    sh = estimate_sequence_sharded(frames[blocks], K,
                                   keys_np.reshape(2, 4, 2), cfg, twice)
    ran = launched()
    sh = {k: v.reshape(8, *v.shape[2:]) for k, v in sh.items()}
    same = {k: bool(torch.equal(sh[k], flat[k]))
            for k in ("valid", "num_matches", "num_inliers")}
    dR = float((sh["R"] - flat["R"]).abs().max())
    dt = float((sh["t"] - flat["t"]).abs().max())
    check("[mesh] estimate_sequence_sharded on [cuda:0, cuda:0]",
          all(same.values()) and dR <= 1e-5 and dt <= 1e-4
          and ran == {k: 2 for k in k1_k4} | kernels.geometry_launches(2),
          f"equal {same}; max |dR| {dR:.3g} (<= 1e-5), |dt| {dt:.3g} (<= "
          f"1e-4); launches {ran} (K1-K4 and P1 once per shard, P2 "
          f"{kernels.P2_PER_CALL} times per shard)")
    res["sequence_sharded"] = dict(max_abs_dR=dR, max_abs_dt=dt,
                                   launches=ran)

    # d. estimate_pairs_2d on a (1, 2) mesh of the card for the 8 pairs,
    # against estimate_pair (tests/test_parallel.py's contract), and 2 of
    # the pairs on a (1, 2) CPU mesh against the card's
    mesh2d = Mesh([["cuda:0", "cuda:0"]], ("pairs", "hyp"))
    kernels.reset_launches()
    t0 = time.perf_counter()
    p2 = estimate_pairs_2d(frames[:-1], frames[1:], K, keys_np, cfg, mesh2d)
    ran = launched()
    res["pairs_2d_ms"] = (time.perf_counter() - t0) * 1e3
    v2d = p2["valid"].cpu().numpy()
    R2d = p2["R"].cpu().numpy()
    one = [estimate_pair(frames[b], frames[b + 1], K, keys_np[b], cfg)
           for b in range(8)]
    v1 = np.array([bool(o["valid"]) for o in one])
    d1 = rotation_error_deg(R2d, np.stack([o["R"].cpu().numpy()
                                           for o in one]))
    want = {"fast_harris": 1, "extract_brief": 1, "match_hamming": 1,
            "five_point_roots": 2, "five_point_coeffs": 2,
            "fixed_order_bmm": kernels.P2_PAIRS_2D} \
        | kernels.SMALL_SOLVERS_PAIRS_2D
    check("[mesh] estimate_pairs_2d on a (1, 2) mesh of the card",
          bool((v2d == v1).all()) and bool((d1[v1] < 1.0).all())
          and ran == want,
          f"valid {v2d.tolist()} estimate_pair {v1.tolist()}; rotation "
          f"difference (deg) {[round(float(x), 4) for x in d1]} (< 1); "
          f"launches {ran} (want {want}: detection and matching once, "
          f"K4 and P1 once per hyp shard); {res['pairs_2d_ms']:.1f} ms "
          f"({card})")
    t0 = time.perf_counter()
    cpu = estimate_pairs_2d(frames[:2], frames[1:3], K, keys_np[:2], cfg,
                            Mesh([["cpu", "cpu"]], ("pairs", "hyp")))
    vc = cpu["valid"].numpy()
    dc = rotation_error_deg(R2d[:2], cpu["R"].numpy())
    check("[mesh] estimate_pairs_2d CUDA vs CPU (pairs 0-1)",
          bool((vc == v2d[:2]).all()) and bool((dc <= 0.5).all()),
          f"valid cuda {v2d[:2].tolist()} cpu {vc.tolist()}, rotation "
          f"difference (deg) {[float(x) for x in dc]} (<= 0.5); CPU "
          f"{time.perf_counter() - t0:.1f} s")
    res["pairs_2d"] = dict(valid=v2d.tolist(),
                           rot_vs_estimate_pair_deg=[float(x) for x in d1],
                           rot_cuda_vs_cpu_deg=[float(x) for x in dc],
                           launches=ran)
    # e. sharded_error_stats over a one-process NCCL group on loopback:
    # phase 5's per-pair rotation errors against the scene
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    joined = initialize_distributed(f"127.0.0.1:{port}", 1, 0)
    try:
        e = rotation_error_deg(phase5["R"], phase5["R_gt"][None]).astype(
            np.float32)
        v = np.array(phase5["valid"])
        v[:n_pairs // 2] = False     # the first of two shards: none valid
        want = {k: float(x) for k, x in dict(
            mean=e[v].mean(), std=e[v].std(), max=e[v].max(),
            min=e[v].min(), count=v.sum()).items()}
        rows = []
        for label, mesh in (("global_pairs_mesh", global_pairs_mesh()),
                            ("[cuda:0, cuda:0]", Mesh(
                                twice.devices, ("pairs",),
                                group=dist.group.WORLD))):
            st = {k: float(x) for k, x in sharded_error_stats(
                torch.from_numpy(e), torch.from_numpy(v), mesh).items()}
            ok = joined and st["count"] == want["count"] and all(
                abs(st[k] - want[k]) <= tol * abs(want[k])
                for k, tol in (("mean", 1e-5), ("max", 1e-6),
                               ("min", 1e-6), ("std", 1e-4)))
            check(f"[mesh] sharded_error_stats, NCCL group of 1, {label}", ok,
                  f"{st} against numpy {want} (mean rtol 1e-5, max/min "
                  f"1e-6, std 1e-4, count exact)")
            rows.append(st)
        res["error_stats"] = rows
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    res["phase_s"] = time.perf_counter() - t_phase
    say(f"[mesh] phase: {res['phase_s']:.1f} s")
    return res



@contextlib.contextmanager
def _gates(gates):
    """Set the environment variables `gates` for the block, then restore
    what was there."""
    old = {k: os.environ.get(k) for k in gates}
    os.environ.update(gates)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _edge_slots(torch, np, dev, f, nb, cap, seed=3):
    """Seeded (f, nb * 32, 320) atlases at band 32 with slot tables that
    stress the extraction kernels: band 0 all live, band 1 all parked, band
    2's 12 live slots over a constant raw region (zero moments), the last
    band's slots at the right and bottom edges, at x0 = 0 and two past the
    edges; the other bands live first, then parked, as `band_tables` fills
    them. Returns (args, live, constant-raw slots), masks (F, S)."""
    g = np.random.default_rng(seed)
    wp, band, p = 320, 32, 31
    ha = nb * band
    atlas = g.uniform(0, 255, (f, ha, wp)).astype(np.float32)
    atlas[:, 64:127, :100] = 77.0
    blur = g.uniform(0, 255, (f, ha, wp)).astype(np.float32)
    x0 = g.integers(0, wp - p + 1, (f, nb, cap))
    ry = g.integers(0, band, (f, nb, cap))
    n_live = g.integers(0, cap + 1, (f, nb))
    n_live[:, 0], n_live[:, 1], n_live[:, 2] = cap, 0, 12
    x0[:, 2, :12] = g.integers(0, 70, (f, 12))
    last = nb - 1
    n_live[:, last] = 8
    x0[:, last, :4], ry[:, last, :4] = wp - p, ha - p - last * band
    x0[:, last, 4] = 0
    x0[:, last, 5], ry[:, last, 5] = wp - p, 0
    x0[:, last, 6:8], ry[:, last, 6:8] = wp - 5, band - 1
    ry = np.where(np.arange(cap) < n_live[..., None], ry, -31)
    const = np.zeros((f, nb, cap), bool)
    const[:, 2, :12] = True
    args = (torch.from_numpy(atlas).to(dev), torch.from_numpy(blur).to(dev),
            torch.from_numpy(x0.astype(np.int32)).to(dev),
            torch.from_numpy(ry.astype(np.int32)).to(dev), band)
    return args, *(torch.from_numpy(m.reshape(f, -1)).to(dev)
                   for m in (ry >= 0, const))


def brief_footprints(torch, m10, m01, live, kind=None):
    """Row-major patch indices that K2-K12 need of each live slot, given
    the (F, S) moments and live mask: "whole" the patch (961,), "ic" the
    IC mask's pixels (749,), "k2" (L, 512) the pattern `kind` (RPE_BRIEF
    unless given) rotated to each live slot's angle atan2(m01, m10) and
    "k12" (L, 512) its steering bin's samples, as the plain versions
    sample them."""
    import numpy as np

    from rpe_tpu_torch.ops.orb import PATCH, _ic_angle_masks, angle_bins, \
        brief_bin_tables, steered_sample_index

    dev = m10.device
    ix, iy = brief_bin_tables(kind=kind)
    k12 = torch.from_numpy((iy * PATCH + ix).astype(np.int64)).to(dev)
    return dict(
        whole=torch.arange(PATCH * PATCH, device=dev),
        ic=torch.from_numpy(np.flatnonzero(_ic_angle_masks()[0])).to(dev),
        k2=steered_sample_index(torch.atan2(m01, m10)[live], kind=kind),
        k12=k12[angle_bins(m10[live], m01[live]).long()])


def union_px(torch, tbl_x0, rel_y, band, ha, wp, foot, patch=31, group=1):
    """Pixels of the (F, HA, WP) atlas that at least one live slot reads
    (rel_y >= 0; patch top-left at (b * band + rel_y, x0), clamped to the
    atlas as the gather is). `foot` holds row-major patch indices
    iy * patch + ix: (P,) read by every live slot, or (L, P), row l read by
    the l-th live slot in (F, NB, CAP) order. With `group`, the runs of
    `group` pixels of a row (WP % group == 0) that hold such a pixel."""
    if wp % group:
        raise ValueError(f"atlas width {wp} is not a multiple of {group}")
    f, nb, _ = tbl_x0.shape
    dev = rel_y.device
    live = rel_y >= 0
    y0 = (torch.arange(nb, device=dev)[None, :, None] * band
          + rel_y.long())[live]
    x0 = tbl_x0.long()[live]
    fr = torch.arange(f, device=dev)[:, None, None].expand_as(live)[live]
    foot = foot.long()
    rows = (y0[:, None] + foot // patch).clamp(0, ha - 1)
    cols = (x0[:, None] + foot % patch).clamp(0, wp - 1)
    cover = torch.zeros(f * ha * wp, dtype=torch.bool, device=dev)
    cover[((fr[:, None] * ha + rows) * wp + cols).reshape(-1)] = True
    return int(cover.view(-1, group).any(1).sum())


def _five_point_contract(np, fp, coeffs, kern, plain):
    """K4 contract (tests/test_pallas_kernels.py:143-184): how many kernel
    roots satisfy the cubic system in its chart to 2e-4 * max(1, |x|, |y|,
    |r|)^3; the largest polished |z| (< 1.2e3); the plain version's converged roots
    (same residual test) reappear among the kernel's roots of the same
    hypothesis (|dz| <= 1e-3 * max(1, |z|)). Also returns the largest |dz|
    of a reproduced root."""
    c = coeffs.double().cpu().numpy()
    P = fp._flip_table().astype(np.float64)
    exps = np.array(fp._M3)

    def residual_ratio(x, y, r, flip, b):
        cc = c[b] @ P if flip else c[b]
        mono = x ** exps[:, 0] * y ** exps[:, 1] * r ** exps[:, 2]
        scale = max(1.0, abs(x), abs(y), abs(r)) ** 3
        return np.abs(cc @ mono).max() / (2e-4 * scale)

    def unpack(t):
        return [a.cpu().numpy().astype(np.float64)
                if a.is_floating_point() else a.cpu().numpy() for a in t]

    xk, yk, rk, fk, hk = unpack(kern)
    xp, yp, rp, fpl, hp = unpack(plain)
    zk = np.where(fk, 1.0 / np.where(np.abs(rk) > 1e-12, rk, 1.0), rk)
    zp = np.where(fpl, 1.0 / np.where(np.abs(rp) > 1e-12, rp, 1.0), rp)
    worst, n_roots, good = 0.0, 0, 0
    for b, r in zip(*np.nonzero(hk)):
        q = residual_ratio(xk[b, r], yk[b, r], rk[b, r], fk[b, r], b)
        worst = max(worst, q)
        good += int(q < 1.0)
        n_roots += 1
    zmax = float(np.abs(zk[hk]).max()) if hk.any() else 0.0
    reproduced = n_conv = 0
    dz = 0.0
    for b, r in zip(*np.nonzero(hp)):
        if not np.isfinite([xp[b, r], yp[b, r], rp[b, r]]).all():
            continue
        if residual_ratio(xp[b, r], yp[b, r], rp[b, r], fpl[b, r], b) >= 1.0:
            continue
        n_conv += 1
        tol = 1e-3 * max(1.0, abs(zp[b, r]))
        near = hk[b] & (np.abs(zk[b] - zp[b, r]) <= tol)
        if near.any():
            reproduced += 1
            dz = max(dz, float(np.abs(zk[b][near] - zp[b, r]).min()))
    return good, n_roots, worst, zmax, reproduced, n_conv, dz


def _bracket_contract(np, torch, fp, c):
    """K5 on coefficients c (B, 10, 20) against its plain version, and
    both against the plain version in float64 (the arbiter). A slot is
    wrong against a reference where has_root differs, or where both have a
    root and an endpoint lies more than one grid step away (another grid
    interval); `near` is the share of slots rooted on both sides whose
    endpoints lie within two final bisection widths."""
    step = float(np.pi / (fp.GRID - 1))
    width = step / (1 << fp.BISECT_ITERS)
    kern = fp.find_root_brackets(c)
    plain = fp.find_root_brackets_plain(c)
    f64 = [x.float() if x.is_floating_point() else x
           for x in fp.find_root_brackets_plain(c.double())]

    def compare(x, ref):
        both = x[2] & ref[2]
        dlo, dhi = (x[0] - ref[0]).abs(), (x[1] - ref[1]).abs()
        far = both & ((dlo > step) | (dhi > step))
        near = both & (dlo <= 2 * width) & (dhi <= 2 * width)
        return (int((x[2] != ref[2]).sum() + far.sum()),
                float(near.sum()) / max(int(both.sum()), 1),
                float(torch.maximum(dlo[both].max(), dhi[both].max())))

    wrong, near, err = compare(kern, plain)
    return dict(n_has=int(kern[2].sum()),
                n_diff=int((kern[2] != plain[2]).sum()), wrong=wrong,
                near=near, err=err, step=step,
                k_wrong=compare(kern, f64)[0], p_wrong=compare(plain, f64)[0],
                k_near=compare(kern, f64)[1],
                empty0=bool((kern[0][~kern[2]] == 0).all()
                            and (kern[1][~kern[2]] == 0).all()))


def _profile_main_path(torch, np, estimate, cfgs, card):
    """--profile: pairs/s over repeated chunks -- ORB at B = 8 and 32, the
    SIFT configs at B = 8 (bench.py's SIFT batch) -- and a torch.profiler
    trace of one B = 8 chunk per config (device time by kernel, device busy
    share, kernel launches); the tables go to OUT_DIR."""
    from torch.profiler import ProfilerActivity, profile

    from rpe_tpu_torch.utils.synthetic import make_sequence

    frames, K, _ = make_sequence(33, H, W, seed=0)
    for name, cfg in cfgs.items():
        for b in ((8, 32) if name == "ORB" else (8,)):
            keys = np.stack([np.array([0, i], np.uint32) for i in range(b)])
            estimate(frames[:b + 1], K, keys, cfg)
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                estimate(frames[:b + 1], K, keys, cfg)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            say(f"profile: {name} B={b} chunk ms "
                f"{[round(t * 1e3, 2) for t in times]} -> median "
                f"{b / float(np.median(times)):.2f} pairs/s ({card})")
    _sift_peak_memory(torch, estimate, frames, K, cfgs, card)
    # kernel name fragment (as the profiler shows it) -> table label
    ours_by_name = {
        "fast_harris_kernel": "fast_harris", "extract_brief_kernel":
        "extract_brief", "hamming_tc_kernel<false>": "match_hamming",
        "hamming_tc_kernel<true>": "row_top2_hamming",
        "l2_tc_kernel<false>": "match_l2",
        "l2_tc_kernel<true>": "row_top2_l2", "split_kernel": "l2 split",
        "roots_kernel": "roots", "polish_kernel": "polish",
        "coeffs_kernel": "five_point_coeffs", "bmm_kernel": "fixed_order",
        "ori_hist_kernel": "sift_orientation_hist",
        "desc_kernel": "sift_descriptor"} | {
        v: k for k, v in SMALL_KERNEL_NAMES.items()}
    keys = np.stack([np.array([0, i], np.uint32) for i in range(8)])
    for name, cfg in cfgs.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            estimate(frames[:9], K, keys, cfg)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        ka = prof.key_averages()
        # device-side events only (kernels and copies): aten ops also report
        # the device time of the kernels they launch, which would count twice
        dev = [e for e in prof.events()
               if str(getattr(e, "device_type", "")).endswith("CUDA")]
        busy = sum(e.time_range.elapsed_us() for e in dev) / 1e3
        ours = {}
        for e in dev:
            for frag, label in ours_by_name.items():
                if frag in e.name:
                    ours[label] = (ours.get(label, 0.0)
                                   + e.time_range.elapsed_us() / 1e3)
        say(f"profile: {name} B=8 wall {wall * 1e3:.1f} ms (profiled), "
            f"device busy {busy:.2f} ms = {100 * busy / (wall * 1e3):.1f}%, "
            f"{len(dev)} device events; port kernels ms "
            f"{ {k: round(v, 4) for k, v in ours.items()} } ({card})")
        table = ka.table(sort_by="self_cuda_time_total", row_limit=30)
        tag = name.replace(" ", "_").lower()
        with open(OUT_DIR / f"profile_{tag}.txt", "w") as f:
            f.write(table)
            f.write("\n\n" + ka.table(sort_by="cpu_time_total", row_limit=30))
        for line in table.splitlines()[:14]:
            say(f"profile[{name}]| {line}")


def _sift_peak_memory(torch, estimate, frames, K, cfgs, card):
    """--profile: peak device memory and host-clock time of one SIFT chunk
    (B = 8) per SIFT config with P3 and P4, and with their plain versions
    (one-hot products, gathered patches) in their place, in turns: kernels,
    plain, plain, kernels."""
    import numpy as np

    from rpe_tpu_torch.ops import sift

    keys = np.stack([np.array([0, i], np.uint32) for i in range(8)])
    kern = sift.orientation_hist, sift.descriptor

    def plain_ori(*a, detail=False):
        return sift.orientation_hist_plain(*a, detail)

    def plain_desc(gxp, gyp, pidx, *r, detail=False):
        return sift.descriptor_plain(sift._take(gxp, pidx),
                                     sift._take(gyp, pidx), *r, detail)

    for name, cfg in cfgs.items():
        if cfg.feature_method != "SIFT":
            continue
        got = {"kernels": [], "plain": []}
        for mode in ("kernels", "plain", "plain", "kernels"):
            sift.orientation_hist, sift.descriptor = (
                kern if mode == "kernels" else (plain_ori, plain_desc))
            try:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                estimate(frames[:9], K, keys, cfg)
                torch.cuda.synchronize()
                got[mode].append((torch.cuda.max_memory_allocated() / 2**30,
                                  (time.perf_counter() - t0) * 1e3))
            finally:
                sift.orientation_hist, sift.descriptor = kern
        say(f"profile: {name} B=8 peak device memory and chunk ms: P3/P4 "
            f"{[(round(g, 3), round(t, 1)) for g, t in got['kernels']]}, "
            f"their plain versions "
            f"{[(round(g, 3), round(t, 1)) for g, t in got['plain']]} "
            f"(GiB, ms; the first run of each after the other's; {card})")


def _main_path_coeffs(torch, dets, cfg, K, dev):
    """K4's input on the main path: the constraint coefficients (B * 256,
    10, 20) of `_main_path_samples`."""
    from rpe_tpu_torch.geometry import five_point as fp

    with torch.no_grad():
        _, coeffs = fp.constraint_coeffs(
            *_main_path_samples(torch, dets, cfg, K, dev))
    return coeffs.reshape(-1, 10, 20).contiguous()


def _main_path_samples(torch, dets, cfg, K, dev):
    """P1's input on the main path: 256 minimal samples (B, 256, 5, 2) per
    pair of the ORB detections `dets` (frames 0..B-1 against 1..B), from
    Hamming cross-check matches and the sampler's keys 0..B-1."""
    from rpe_tpu_torch import rng
    from rpe_tpu_torch.geometry.epipolar import normalize_points
    from rpe_tpu_torch.geometry.ransac import gather_points, \
        sample_minimal_indices
    from rpe_tpu_torch.pipeline.estimator import match_features

    with torch.no_grad():
        d1 = {k: v[:-1] for k, v in dets.items()}
        d2 = {k: v[1:] for k, v in dets.items()}
        mt = match_features(d1, d2, cfg)
        Kt = torch.from_numpy(K).to(dev)
        p1 = normalize_points(torch.gather(
            d1["xy"], 1, mt["idx1"][..., None].expand(-1, -1, 2)), Kt)
        p2 = normalize_points(torch.gather(
            d2["xy"], 1, mt["idx2"][..., None].expand(-1, -1, 2)), Kt)
        keys = torch.stack([rng.PRNGKey(i, device=dev)
                            for i in range(d1["xy"].shape[0])])
        idx = sample_minimal_indices(keys, mt["valid"],
                                     cfg.ransac.num_hypotheses, 5)
        return gather_points(p1, idx), gather_points(p2, idx)


def _record_p2(torch, run):
    """The terms of every P2 launch that `run()` makes (geometry/
    _products.py `fixed_order_group`: (a, b), (a, None) for a row sum,
    (a, a2, b) for a chain), copied as the launch got them, and the bytes
    each launch must read: the distinct float32 elements its operands
    address, an element that two operands share (A^T @ A, E^T @ E, the U
    of both rotations) or that a broadcast repeats counted once."""
    from rpe_tpu_torch.geometry import _products as prods

    launches, reads = [], []
    group = prods.fixed_order_group

    def addresses(x):
        off = torch.full((), x.storage_offset(), dtype=torch.int64,
                         device=x.device)
        for d, (n, st) in enumerate(zip(x.shape, x.stride())):
            view = [1] * x.dim()
            view[d] = n
            off = off + torch.arange(n, device=x.device).view(view) * st
        return off.reshape(-1)

    def distinct(xs):
        by_storage = {}
        for x in xs:
            by_storage.setdefault(x.untyped_storage().data_ptr(), []).append(
                addresses(x))
        return sum(int(torch.unique(torch.cat(v)).numel())
                   for v in by_storage.values())

    def rec_group(terms):
        launches.append([tuple(None if x is None else x.clone() for x in t)
                         for t in terms])
        reads.append(4 * distinct([x for t in terms for x in t
                                    if x is not None]))
        return group(terms)

    prods.fixed_order_group = rec_group
    try:
        with torch.no_grad():
            run()
    finally:
        prods.fixed_order_group = group
    return launches, reads


# P5-P8: the table's label, the reference's code each takes the place of,
# the kernel's name as the profiler shows it, and its operations a problem
# (an output element for P8), counted from csrc/small_solvers.cu: P6 the
# Cardano eigenvalues 59, the two eigenvectors 118, the orthonormalization
# and its fallback 55; P7 90; P8 126 integer operations; P5 `_small_ops`
SMALL_LABELS = {"smallest_eigvec_sym": "P5", "eigh3x3_desc": "P6",
                "essential_frame": "P7", "threefry2x32": "P8"}
SMALL_REPLACES = {
    "smallest_eigvec_sym": "rpe_tpu/geometry/eig.py:96",
    "eigh3x3_desc": "rpe_tpu/geometry/eig.py:30",
    "essential_frame": "rpe_tpu/geometry/epipolar.py:62",
    "threefry2x32": "jax.random threefry2x32 (rpe_tpu/geometry/ransac.py:51)"}
SMALL_KERNEL_NAMES = {
    "smallest_eigvec_sym": "smallest_eigvec_kernel",
    "eigh3x3_desc": "eigh3x3_kernel",
    "essential_frame": "essential_frame_kernel",
    "threefry2x32": "threefry_kernel"}
SMALL_OPS = {"eigh3x3_desc": 232, "essential_frame": 90,
             "threefry2x32": 126}


def _small_ops(n, iters):
    """P5's float operations for one n x n problem and `iters` rounds: the
    trace and jitter, the Cholesky (two a product of the sums over k, then
    a division, or the jitter's add, a clamp and a square root), and each
    round's two triangular solves, norm and divisions."""
    chol = sum(2 * j + (3 if i == j else 1) for i in range(n)
               for j in range(i + 1))
    return n + 2 + chol + iters * (2 * n * n + 3 * n + 2)


def _record_small(torch, run):
    """The arguments of every call of P5-P8's public functions that `run()`
    makes, cloned as the call got them, by launch counter."""
    from torch_judges import SMALL_SOLVERS, small_solvers_patched

    calls = {k: [] for k in SMALL_SOLVERS}

    def wrap(name, fn):
        def rec(*a, **k):
            a = a + tuple(k.values())       # `iters`, the one keyword
            calls[name].append(tuple(x.clone() if torch.is_tensor(x) else x
                                     for x in a))
            return fn(*a)
        return rec

    with torch.no_grad(), small_solvers_patched(wrap):
        run()
    return calls


def _small_fn(name, plain=False):
    import importlib

    from torch_judges import SMALL_SOLVERS

    m, fn, pl = SMALL_SOLVERS[name]
    return getattr(importlib.import_module(m), pl if plain else fn)


def _small_run(name, calls, plain=False):
    """Every recorded call of kernel `name` (or of its plain version)."""
    fn = _small_fn(name, plain)
    return [fn(*a) for a in calls]


def _small_contract(torch, name, calls):
    """(bit-equal to the plain version on every call, bit-equal with each
    call's batch split in two (P5-P7; P8's words are exact integers),
    outputs compared)."""
    from torch_judges import same_bits

    fn, plain = _small_fn(name), _small_fn(name, plain=True)

    def outs(x):
        return x if isinstance(x, tuple) else (x,)

    ok, split, n = True, True, 0
    for a in calls:
        got = outs(fn(*a))
        ok &= all(same_bits(g, p) for g, p in zip(got, outs(plain(*a))))
        n += sum(g.numel() for g in got)
        h = a[0].shape[0] // 2
        if name != "threefry2x32" and h:
            parts = [outs(fn(*(x[:h] if torch.is_tensor(x) else x
                               for x in a))),
                     outs(fn(*(x[h:] if torch.is_tensor(x) else x
                               for x in a)))]
            split &= all(same_bits(torch.cat(c), g)
                         for c, g in zip(zip(*parts), got))
    return bool(ok), bool(split), n


def _small_work(name, calls):
    """Bytes (inputs read once, outputs written once) and float operations
    of every recorded call of kernel `name`."""
    nbytes = nops = 0
    for a in calls:
        out = _small_fn(name)(*a)
        out = out if isinstance(out, tuple) else (out,)
        nbytes += sum(x.numel() * x.element_size() for x in a
                      if hasattr(x, "numel")) + sum(
            o.numel() * o.element_size() for o in out)
        if name == "smallest_eigvec_sym":
            n = a[0].shape[-1]
            nops += a[0].numel() // (n * n) * _small_ops(
                n, a[1] if len(a) > 1 else 3)
        else:
            nops += out[0].numel() // (1 if name == "threefry2x32"
                                       else out[0].shape[-1] if name ==
                                       "eigh3x3_desc" else 9) \
                * SMALL_OPS[name]
    return nbytes, nops


def _p2_run(terms):
    """One P2 launch of the recorded terms."""
    from rpe_tpu_torch.geometry import _products as prods

    return prods.fixed_order_group(terms)


def _p2_plain(terms):
    """The same terms as PyTorch computes them: torch.matmul (a chain as
    two), .sum(-1)."""
    import torch

    return [t[0].sum(-1) if t[1] is None else torch.matmul(t[0], t[1])
            if len(t) == 2 else torch.matmul(t[0], torch.matmul(t[1], t[2]))
            for t in terms]


def _p2_serial(t):
    """tests/torch_judges.py `p2_serial` of one term."""
    from torch_judges import p2_serial

    return p2_serial(t[0], t[1]) if len(t) == 2 else p2_serial(
        t[0], t[2], a2=t[1])


def _op_shape(terms):
    return tuple(tuple(None if x is None else tuple(x.shape) for x in t)
                 for t in terms)


def _p2_contract(torch, launches, reads):
    """P2 on each recorded launch, term by term: bit-equal to the serial
    float64 reference (`_p2_serial`); against torch.matmul / .sum(-1) and
    the float64 product of its operands (tests/torch_judges.py `p2_judge`,
    a chain's outer product taken of the reference's inner one); bit-equal
    with the batch split in two along its first axis. Returns (all held
    to p2_judge; the largest absolute difference from the plain; the
    largest relative errors of `p2_judge`; terms that differ from the
    serial reference; split held; the bytes read (`reads`, from
    `_record_p2`) and written once; the float operations)."""
    from torch_judges import p2_judge

    ok, err, split, nbytes, flops = True, 0.0, True, sum(reads), 0
    serial_diff = 0
    rels = [0.0, 0.0, 0.0]
    for terms in launches:
        gots = _p2_run(terms)
        for t, got, want in zip(terms, gots, _p2_plain(terms)):
            ref = _p2_serial(t)
            serial_diff += int(not torch.equal(got, ref))
            a = t[0]
            b = t[1] if len(t) == 2 else _p2_serial(t[1:])
            if b is None:
                exact, scale = a.double().sum(-1), a.abs().double().sum(-1)
            else:
                exact = torch.matmul(a.double(), b.double())
                scale = torch.matmul(a.abs().double(), b.abs().double())
            fine, *r = p2_judge(got, want, exact, scale)
            ok = ok and fine
            rels = [max(x, y) for x, y in zip(rels, r)]
            d = (got - want).abs()
            err = max(err, float(torch.nan_to_num(d, nan=0.0).max()))
            nbytes += 4 * got.numel()
            k = a.shape[-1]
            flops += got.numel() * (k if b is None else 2 * k)
            if len(t) == 3:
                flops += _p2_serial(t[1:]).numel() * 2 * t[1].shape[-1]
        n0 = gots[0].shape[0] if gots[0].dim() else 1
        if n0 > 1 and all(g.dim() and g.shape[0] == n0 for g in gots):
            h = n0 // 2

            def cut(x, got, row_sum, sl):
                return x[sl] if x is not None and x.dim() == got.dim() + (
                    row_sum) and x.shape[0] == n0 else x

            parts = [_p2_run([tuple(cut(x, g, t[1] is None, sl) for x in t)
                              for t, g in zip(terms, gots)])
                     for sl in (slice(0, h), slice(h, n0))]
            split = split and all(
                torch.equal(torch.cat([p[j] for p in parts]), g)
                for j, g in enumerate(gots))
    return ok, err, rels, serial_diff, split, nbytes, flops


def _exact_minimal_coeffs(np, torch, fp, b, dev):
    """K4 input from `_exact_minimal_problems`: their constraint
    coefficients (b, 10, 20)."""
    _, c = fp.constraint_coeffs(*_exact_minimal_problems(np, torch, b, dev))
    return c.contiguous()


def _exact_minimal_problems(np, torch, b, dev):
    """b noise-free minimal problems (random rotation of 2-30 deg, unit
    translation, 5 points at depth 3-10), the construction of the
    reference's kernel test: pts1, pts2 (b, 5, 2) float32."""
    from rpe_tpu_torch.utils.synthetic import rotation_from_axis_angle

    g = np.random.default_rng(5)
    p1s, p2s = [], []
    for _ in range(b):
        w = g.normal(size=3)
        R = rotation_from_axis_angle(
            w / np.linalg.norm(w) * np.deg2rad(g.uniform(2, 30)))
        t = g.normal(size=3)
        t /= np.linalg.norm(t)
        X = g.uniform([-2, -2, 3], [2, 2, 10], size=(5, 3))
        X2 = X @ R.T + t
        p1s.append((X / X[:, 2:3])[:, :2])
        p2s.append((X2 / X2[:, 2:3])[:, :2])
    return (torch.tensor(np.stack(p1s), dtype=torch.float32, device=dev),
            torch.tensor(np.stack(p2s), dtype=torch.float32, device=dev))


if __name__ == "__main__":
    main()
