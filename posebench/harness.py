"""One run of one cell: set-up, the measured window, the traced sub-window,
the check of what the window produced, and the result line.

The window is a closed loop with one client. Each call hands the program's
entry `estimate_sequence_batched` a chunk of B + 1 frames (B pairs) from a
pool of distinct chunks made at set-up, and ends when that call's R, t,
valid and inlier counts are on the host. Calls cycle through the pool, so
no call repeats the previous call's frames. Every call of the window counts.

What the check reads, it takes from the timed path itself: wrappers around
the entry module's `detect_features` and `match_features` keep references
to what those returned in a few calls drawn from the seed, and the window
keeps those calls' outputs. Nothing is computed a second time.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

import devtrace
import roofline
import scene

FORBIDDEN = ("jax", "jaxlib", "flax", "rpe_tpu")

# How every run warms up, samples and traces, whatever the cell (the tests
# set smaller values): one call at the cell's exact shapes before the
# window; the check reads CHECK_PAIRS pairs (one from each part of the
# chunk) of CHECK_CALLS calls drawn from the seed among the window's calls
# 1 .. CHECK_SPAN x the pool's chunks (the window runs on until they are
# done); a --trace 1 run profiles TRACE_CALLS whole calls from the window's
# call TRACE_FIRST on.
WARM_CALLS = 1
CHECK_CALLS = 2
CHECK_PAIRS = 4
CHECK_SPAN = 4
TRACE_FIRST = 2
TRACE_CALLS = 2


class CheckError(RuntimeError):
    """What the window returned does not have the shape the check reads."""


class Capture:
    """Keeps what the timed path's detection and matching returned in the
    calls in `wanted`, and, while `counting`, the terms of the traced calls'
    5-point roots and P2 products (the roofline's live counts)."""

    def __init__(self, est, wanted):
        self.est = est
        self.wanted = set(wanted)
        self.call = -1
        self.dets, self.matches, self.outs = {}, {}, {}
        self.counting = False
        self.roots, self.p2 = [], []
        self.state = {}
        self._det, self._match = est.detect_features, est.match_features
        self._patched = []

    def _wrap_det(self, imgs, cfg):
        out = self._det(imgs, cfg)
        if self.call in self.wanted or self.counting:
            self.dets[self.call] = out
        return out

    def _wrap_match(self, det1, det2, cfg):
        out = self._match(det1, det2, cfg)
        if self.call in self.wanted:
            self.matches[self.call] = out
        return out

    def install(self):
        from rpe_tpu_torch.geometry import _products, five_point
        from rpe_tpu_torch.ops import orb

        kp_orb = orb.atlas_keypoints

        def wrap_kp_orb(*a, **k):
            out = kp_orb(*a, **k)
            if self.call in self.wanted:
                # ORB's keypoints before the extraction bands' cap: the
                # per-level selection (small arrays; the atlas is not kept)
                self.state[self.call] = [{n: out[n] for n in (
                    "xy_atlas", "xy_base", "level", "score", "valid")}]
            return out

        fpe, grp = five_point.five_point_essential, _products.fixed_order_group

        def wrap_fpe(*a, **k):
            E, ok = fpe(*a, **k)
            if self.counting:
                self.roots.append(ok)
            return E, ok

        def wrap_grp(terms):
            outs = grp(terms)
            if self.counting:
                self.p2.append(roofline.p2_terms(terms, outs))
            return outs

        self._patched = [(self.est, "detect_features", self._det),
                         (self.est, "match_features", self._match),
                         (five_point, "five_point_essential", fpe),
                         (_products, "fixed_order_group", grp),
                         (orb, "atlas_keypoints", kp_orb)]
        orb.atlas_keypoints = wrap_kp_orb
        self._install_sift()
        self.est.detect_features = self._wrap_det
        self.est.match_features = self._wrap_match
        five_point.five_point_essential = wrap_fpe
        _products.fixed_order_group = wrap_grp

    def _install_sift(self):
        """SIFT's keypoint state at its descriptor stage, per octave: the
        extrema selected for refinement (`select_candidates`' scores and
        flat indices), the Gaussian stack, the refined octave coordinates,
        continuous and integer layers and validity (`keypoint_patches`'
        arguments) and the output slots' sources and angles
        (`descriptor`'s)."""
        from rpe_tpu_torch.ops import sift

        kp, desc = sift.keypoint_patches, sift.descriptor
        sel = sift.select_candidates
        picked = {}

        def wrap_sel(vals, quota, *a, **k):
            out = sel(vals, quota, *a, **k)
            picked["last"] = out
            return out

        def wrap_kp(G, xy, lay, valid, kint):
            out = kp(G, xy, lay, valid, kint)
            if self.call in self.wanted or self.counting:
                st = {"xy": out[0], "lay": lay, "kint": kint, "valid": valid,
                      "shape": tuple(G.shape[-2:])}
                if self.call in self.wanted:
                    st["G"] = G
                    st["score0"], st["flat"] = picked["last"]
                self.state.setdefault(self.call, []).append(st)
            picked.clear()
            return out

        def wrap_desc(gxp, gyp, pidx, ucx, ucy, scl, theta, **kw):
            if self.call in self.wanted or self.counting:
                self.state[self.call][-1].update(pidx=pidx, theta=theta)
            return desc(gxp, gyp, pidx, ucx, ucy, scl, theta, **kw)

        self._patched += [(sift, "keypoint_patches", kp),
                          (sift, "descriptor", desc),
                          (sift, "select_candidates", sel)]
        sift.select_candidates = wrap_sel
        sift.keypoint_patches = wrap_kp
        sift.descriptor = wrap_desc

    def uninstall(self):
        for mod, name, fn in self._patched:
            setattr(mod, name, fn)
        self._patched = []


def estimator_config(est: dict):
    """The program's EstimatorConfig with the configuration file's fields."""
    from rpe_tpu_torch.config import EstimatorConfig

    base = EstimatorConfig()
    kw = {}
    for k, v in est.items():
        cur = getattr(base, k)
        kw[k] = (dataclasses.replace(cur, **v)
                 if dataclasses.is_dataclass(cur) else v)
    return dataclasses.replace(base, **kw)


def sample_plan(seed: int, pool: int, b: int):
    """Which calls the check reads (drawn over calls 1 .. CHECK_SPAN x
    pool, whatever the pace of the window) and which pairs of each: one
    from each of CHECK_PAIRS parts of the chunk (at most b)."""
    rng = np.random.default_rng(scene.mix_seed(seed, 20))
    n = CHECK_SPAN * pool
    k = min(CHECK_CALLS, n)
    calls = sorted(1 + int(c) for c in rng.choice(n, size=k, replace=False))
    q = min(CHECK_PAIRS, b)
    pairs = {c: sorted({int(rng.integers(j * b // q, max((j + 1) * b // q,
                                                        j * b // q + 1)))
                        for j in range(q)}) for c in calls}
    return calls, pairs


def chunk_of(call: int, pool: int) -> int:
    """The pool's chunk that window call `call` takes (a warm call is
    numbered below 0): the warm calls and the window cycle through the
    pool in one sequence, so no call repeats the frames of the call
    before it."""
    return (call + WARM_CALLS) % pool


def host_copy(out):
    """What a user of a sequence waits for: the chunk's R, t, valid and
    inlier counts on the host."""
    return (out["R"].cpu(), out["t"].cpu(), out["valid"].cpu(),
            out["num_inliers"].cpu())


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float,
        log=print, control: bool = False):
    """One run; returns the result dict (or raises). With `control` the
    result also holds the control's numbers on the same sample
    ("control")."""
    from rpe_tpu_torch.pipeline import estimator as est

    traffic, config = cell.traffic, cell.config
    cfg = estimator_config(config["estimator"])
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    t_pool = time.perf_counter()
    pool = scene.Pool(traffic, seed, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_pool = time.perf_counter() - t_pool
    b = pool.pairs
    K_t = torch.as_tensor(pool.K, dtype=torch.float32, device=dev)
    from rpe_tpu_torch.convert import keys_from_numpy
    keys = [keys_from_numpy(k, device=dev) for k in pool.keys]

    def call(c):
        return est.estimate_sequence_batched(pool.frames[c], K_t, keys[c],
                                             cfg, dev)

    # warm-up: the one chunk shape the window uses
    times = []
    for i in range(WARM_CALLS):
        t0 = time.perf_counter()
        host_copy(call(chunk_of(i - WARM_CALLS, len(pool))))
        times.append(time.perf_counter() - t0)
    setup_s = time.perf_counter() - t_start

    plan_calls, plan_pairs = sample_plan(seed, len(pool), b)
    cap = Capture(est, plan_calls)
    cap.install()
    trace_first = TRACE_FIRST
    trace_calls = TRACE_CALLS if trace else 0
    prof = None
    prof_span = None
    host, ends = [], []
    try:
        t0 = time.perf_counter()
        i = 0
        while True:
            c = chunk_of(i, len(pool))
            cap.call = i
            if trace and i == trace_first:
                from torch.profiler import ProfilerActivity, profile

                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
                cap.counting = True
            if prof is not None and cap.counting:
                with torch.profiler.record_function(devtrace.CALL_SPAN):
                    out = call(c)
                    res = host_copy(out)
            else:
                out = call(c)
                res = host_copy(out)
            host.append((c, res))
            ends.append(time.perf_counter())
            if i in cap.wanted:
                cap.outs[i] = out
            if prof is not None and cap.counting and (
                    i == trace_first + trace_calls - 1):
                cap.counting = False
                prof.__exit__(None, None, None)
                prof_span = (trace_first, i)
            del out
            i += 1
            # the window closes at its length, once the calls that the check
            # reads and the traced calls have run
            if (time.perf_counter() - t0 >= seconds
                    and i > max(cap.wanted, default=-1)
                    and (not trace or prof_span is not None)):
                break
        window_s = time.perf_counter() - t0
    finally:
        cap.uninstall()
    n_calls = len(host)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)

    invalid = sum(int((~r[2].bool()).sum()) for _, r in host)
    result = {"correct": False, "attempted": n_calls * b, "failed": invalid}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": cell.chips, "memory_peak_bytes": int(peak)}

    metrics = {}
    if trace:
        tr = traced(cell, prof, cap, b, trace_calls, config, traffic)
        del prof
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        for m in cell.per_layer:
            v = cell.reader(m["name"]).read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
        log(f"traced calls {trace_first}..{prof_span[1]}: window "
            f"{tr.window_s!r} s, busy {tr.busy_s!r} s, "
            f"{len(tr.device)} device events")
        for unit, (nb, ops, rate) in sorted(tr.counts.items()):
            t_dev = sum(tr.own_time().get(k, 0.0)
                        for k in roofline.UNITS[unit])
            log(f"kernel {unit}: device {t_dev!r} s, bytes {nb!r}, ops "
                f"{ops!r}, bound {roofline.bound_s(nb, ops, rate)!r} s"
                + (f", {100 * roofline.bound_s(nb, ops, rate) / t_dev!r} %"
                   if t_dev > 0 else ""))
    else:
        for m in cell.end_to_end:
            if m["name"] == "pairs_per_s":
                metrics["pairs_per_s"] = {"value": n_calls * b / window_s,
                                          "unit": m["unit"]}
            elif m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": m["unit"]}
    dur = np.diff([t0] + ends)
    q = np.percentile(dur, [0, 25, 50, 75, 100]) if len(dur) else []
    log(f"call seconds min/q1/median/q3/max {[round(float(x), 4) for x in q]}"
        f" (first {dur[0]:.4f}, last {dur[-1]:.4f})")
    log(f"window: {n_calls} calls of {b} pairs in {window_s!r} s; set-up "
        f"{setup_s!r} s (frames {t_pool:.3f} s, {len(times)} warm calls "
        f"{[round(t, 4) for t in times[:3]]}... s)")
    log("call seconds " + " ".join(f"{x:.4f}" for x in dur))

    # the check, once the window has closed and its peak was read: keep
    # the sampled frames and the sampled calls' slices, free the rest
    t_check = time.perf_counter()
    try:
        sample = build_sample(cell, pool, cap, plan_pairs)
        if not sample["pairs"]:
            raise CheckError("the check has no pair to read")
        del pool, keys, cap, host
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        numbers = check(cell, sample, invalid)
        if control:
            result["control"] = check(cell, sample, invalid, control=True)
        log(f"check took {time.perf_counter() - t_check!r} s over "
            f"{len(sample['pairs'])} pairs and {len(sample['frames'])} "
            f"frames")
    except (CheckError, IndexError, ValueError) as e:
        # what the timed path returned cannot be read as the configuration
        # states it: no number holds
        log(f"the check could not read the window's outputs: {e!r}")
        numbers = {k: None for k in cell.limits}
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or the JAX package are loaded: "
                           f"{found}")
    limits = cell.limits
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    ok = all(v["value"] is not None and v["value"] <= v["limit"]
             for v in checks.values())
    for k, v in numbers.items():
        if k not in limits:
            log(f"reading (not compared) {k} = {v!r}")
    for k, v in checks.items():
        bad = v["value"] is None or v["value"] > v["limit"]
        log(f"check {k} = {v['value']!r} (limit {v['limit']!r})"
            f"{'  FAILED' if bad else ''}")
    result.update(correct=ok, metrics=metrics, device=device_info)
    result["checks"] = checks
    return result


def traced(cell, prof, cap, b, calls, config, traffic):
    """The Trace of the profiled calls with the roofline's counts."""
    events = devtrace.events_from_profile(prof)
    kern = devtrace.own_kernels(Path(__file__).resolve().parents[1]
                                / "rpe_tpu_torch" / "csrc")
    counts = {}
    est = config["estimator"]
    h, w = int(traffic["height"]), int(traffic["width"])
    traced_dets = [(i, d) for i, d in sorted(cap.dets.items())
                   if i >= TRACE_FIRST][:calls]
    for i, d in traced_dets:
        if est.get("feature_method", "ORB").upper() == "ORB":
            roofline.add(counts, roofline.orb_counts(d, h, w, est["orb"]))
            roofline.add(counts, roofline.match_counts(
                d, "bits", 1, roofline.INT8_OPS_PER_S, "K3"))
        else:
            roofline.add(counts, roofline.sift_counts(cap.state[i]))
            roofline.add(counts, roofline.match_counts(
                d, "desc", 4, roofline.TF32X3_OPS_PER_S, "K7"))
    roots = sum(int(r.sum()) for r in cap.roots)
    hyps = int(est.get("ransac", {}).get("num_hypotheses", 256))
    roofline.add(counts, roofline.ransac_counts(b * calls, hyps, roots))
    if cap.p2:
        p2 = [roofline.p2_counts(x) for x in cap.p2]
        counts["P2"] = (sum(x[0] for x in p2), sum(x[1] for x in p2),
                        roofline.FP32_OPS_PER_S)
    return devtrace.Trace(events, calls, b * calls, kern, counts)


def build_sample(cell, pool, cap, plan_pairs):
    """The frames, detections, matches and outputs of the sampled pairs, on
    the device, copied out of the window's tensors."""
    b = pool.pairs
    frames, dets, pairs, state = {}, {}, [], {}
    for i in sorted(cap.outs):
        c = chunk_of(i, len(pool))
        det, m, out = cap.dets.get(i), cap.matches.get(i), cap.outs[i]
        if det is None or m is None:
            raise CheckError(f"call {i}: the timed path's detections or "
                               f"matches were not seen")
        n_f = det["valid"].shape[0]
        if n_f != b + 1 or out["R"].shape[0] != b or m["valid"].shape[0] != b:
            raise CheckError(f"call {i}: {n_f} frames of detections, "
                               f"{out['R'].shape[0]} poses and "
                               f"{m['valid'].shape[0]} match sets for "
                               f"{b} pairs")
        for p in plan_pairs[i]:
            for f in (p, p + 1):
                if (i, f) not in frames:
                    frames[(i, f)] = pool.frames[c, f].clone()
                    dets[(i, f)] = {k: v[f].clone() for k, v in det.items()}
                    if i in cap.state:
                        state[(i, f)] = [
                            {k: v[f].clone() for k, v in o.items()
                             if isinstance(v, torch.Tensor)}
                            for o in cap.state[i]]
            pairs.append({
                "call": i, "pair": p, "f1": (i, p), "f2": (i, p + 1),
                "matches": {k: v[p].clone() for k, v in m.items()},
                "pose": {k: out[k][p].clone() for k in (
                    "pts1", "pts2", "match_valid", "inlier_mask",
                    "num_matches", "num_inliers", "valid", "R", "t")},
                "truth": pool.truth[c]})
    dev = pool.frames.device
    return {"config": cell.config, "frames": frames, "dets": dets,
            "pairs": pairs, "state": state,
            "K": torch.as_tensor(pool.K, dtype=torch.float64, device=dev)}


def check(cell, sample, invalid: int, control: bool = False) -> dict:
    """Every number of the configuration's check over a sample, with the
    window's count of invalid pairs and, as a reading not compared, the
    largest rotation error against the scene."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = cell.reference()
    with torch.no_grad():
        numbers = ref.numbers(sample, control=control)
    numbers["invalid_pairs"] = invalid
    from reference import pose

    err = [pose.rotation_error_deg(p["pose"]["R"].cpu(),
                                   torch.as_tensor(p["truth"][0]))
           for p in sample["pairs"]]
    numbers["rot_err_scene_deg"] = max(err) if err else 0.0
    return numbers


def result_line(result: dict) -> str:
    """The result's JSON line, its `checks` key last."""
    checks = result.pop("checks", {})
    result["checks"] = checks
    return json.dumps(result)
