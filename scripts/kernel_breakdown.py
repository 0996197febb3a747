#!/usr/bin/env python3
"""Where K1's (FAST/Harris rank map) and K4's (5-point roots) time goes on
the card, at one chunk's shapes, and how another build of their sources
compares.

    python3 scripts/kernel_breakdown.py
    python3 scripts/kernel_breakdown.py --against DIR   # DIR holds another
                                                        # fast_harris.cu and
                                                        # five_point_roots.cu

Needs a CUDA card and nvcc. Inputs, made from seed 0 as chip_smoke.py makes
them: K1 on the 9 atlases (9, 3200, 1280) of `make_sequence(9, 376, 1241)`;
K4 on the main path's 2048 coefficient sets (8 pairs x 256 samples of the
ORB cross-check matches) and on 2048 exact minimal problems; K5 (K4's
brackets alone) on the latter. For each wrapper it prints:
  - flushed: mean CUDA-event time of one call with the L2 flushed before
    it (chip_smoke.py's measurement; host time between the events counts
    when the card waits for the launch);
  - queued: mean CUDA-event time per call over 20 calls queued back to
    back, and the host's own time per call in that loop;
  - device: per-kernel device time from torch.profiler over 20 calls, the
    mean over the launches it recorded (for K4 its bracket and polish
    kernels apart);
  - the ptxas lines of both sources (registers, spills) and, where the
    toolkit has cuobjdump, each kernel's static SASS instruction count;
  - K1's bits against its plain version: interior pixels (8 px from every
    edge) whose rank or blur bits differ, and the same over the whole image;
  - K1's issue budget: the thread-instructions per pixel its device time
    affords at full issue (132 SMs x 128 lanes a clock at the SM's
    maximum clock).
With --against DIR the sources in DIR are built with the same flags, timed
the same way (in turns: DIR, repo, repo, DIR) and compared with the repo's
kernels: K1 pixels whose bits differ, K4 (hypothesis, root) slots whose
has_root differs or whose root moves by |dz| > 1e-6, K5 slots that differ.
"""

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from rpe_tpu_torch.config import EstimatorConfig  # noqa: E402
from rpe_tpu_torch.geometry import five_point as fp  # noqa: E402
from rpe_tpu_torch.ops import kernels  # noqa: E402
from rpe_tpu_torch.ops.fast import fast_harris_rank_map, \
    fast_harris_rank_map_plain  # noqa: E402
from rpe_tpu_torch.ops.orb import atlas_keypoints  # noqa: E402
from rpe_tpu_torch.pipeline.estimator import detect_features  # noqa: E402
from rpe_tpu_torch.utils.device import full_precision  # noqa: E402
from rpe_tpu_torch.utils.synthetic import make_sequence  # noqa: E402

LIBS = ("fast_harris", "five_point_roots")


def measure(name, fn, flush):
    """flushed / queued / host / per-kernel device times of fn, printed and
    returned."""
    fn()
    torch.cuda.synchronize()
    flushed = []
    for _ in range(10):
        flush.zero_()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        flushed.append(s.elapsed_time(e))
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    t0 = time.perf_counter()
    for _ in range(20):
        fn()
    host = (time.perf_counter() - t0) / 20 * 1e3
    e.record()
    torch.cuda.synchronize()
    queued = s.elapsed_time(e) / 20
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    # per kernel, the mean over the launches the profiler recorded (it may
    # drop some), so a call's device time is the sum of its kernels' means
    tot, cnt = {}, {}
    for ev in prof.events():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            tot[ev.name] = tot.get(ev.name, 0.0) + ev.time_range.elapsed_us()
            cnt[ev.name] = cnt.get(ev.name, 0) + 1
    dev_ms = {k: tot[k] / cnt[k] / 1e3 for k in tot}
    short = {k: n for k, n in cnt.items() if n < 20}
    if short:
        print(f"{name}: the profiler recorded fewer than 20 launches of "
              f"{short}", flush=True)
    parts = ", ".join(f"{k[:40]} {v:.4f}" for k, v in sorted(
        dev_ms.items(), key=lambda kv: -kv[1]))
    r = dict(flushed=float(np.mean(flushed)), flushed_min=min(flushed),
             flushed_max=max(flushed), queued=queued, host=host,
             device=sum(dev_ms.values()), parts=dev_ms)
    print(f"{name}: flushed {r['flushed']:.4f} ms ({r['flushed_min']:.4f}-"
          f"{r['flushed_max']:.4f}), queued {queued:.4f} ms, host "
          f"{host:.4f} ms per call, device {r['device']:.4f} ms ({parts})",
          flush=True)
    return r


def build_parallel(specs, out_dir, tool, tag=""):
    """Compile {name: (library key, source path, -D defines)} with the
    repo's nvcc flags for each key, every nvcc started at once, into
    out_dir/lib{name}.so; print each one's ptxas lines (as tag + name) and
    exit naming `tool` if one fails. Returns {name: (CDLL, library path)}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, (key, src, defs) in specs.items():
        so = out_dir / f"lib{name}.so"
        cmd = [kernels.nvcc_path(), *kernels.NVCC_FLAGS,
               *kernels.SOURCES[key][1], *[f"-D{d}" for d in defs], "-I",
               str(kernels.CSRC), "-o", str(so), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       so)
    out = {}
    for name, (p, so) in procs.items():
        log, _ = p.communicate()
        print_ptxas(f"{tag}{name}", log)
        if p.returncode != 0:
            sys.exit(f"{tool}: {name} ({specs[name][1]}) failed to build:\n"
                     f"{log}")
        out[name] = (ctypes.CDLL(str(so)), so)
    return out


def build_against(src_dir, keys=LIBS, tool="kernel_breakdown"):
    """Build src_dir's sources of the libraries `keys` with the repo's
    flags into libraries of their own; returns {key: CDLL}."""
    built = build_parallel(
        {k: (k, Path(src_dir) / kernels.SOURCES[k][0], ()) for k in keys},
        kernels.BUILD_DIR / "against", tool, tag="against ")
    for k, (_, so) in built.items():
        print_sass(f"against {k}", so)
    return {k: lib for k, (lib, _) in built.items()}


def print_ptxas(tag, log):
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"ptxas[{tag}]: {line.strip()}", flush=True)


def print_sass(tag, so):
    """Static SASS instruction count per kernel (cuobjdump -sass)."""
    tool = Path(kernels.nvcc_path()).parent / "cuobjdump"
    if not tool.exists() and shutil.which("cuobjdump") is None:
        print(f"sass[{tag}]: cuobjdump not found", flush=True)
        return
    p = subprocess.run([str(tool) if tool.exists() else "cuobjdump", "-sass",
                        str(so)], capture_output=True, text=True)
    counts, cur = {}, None
    for line in p.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1)
            counts[cur] = 0
        elif cur and re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[cur] += 1
    for k, n in counts.items():
        print(f"sass[{tag}]: {k} {n} instructions", flush=True)


def bits_differ(a, b):
    return int((a.contiguous().view(torch.int32)
                != b.contiguous().view(torch.int32)).sum())


def k1_bits(tag, got, want, m=8):
    for part, x, y in (("rank", got[0], want[0]), ("blur", got[1], want[1])):
        xi, yi = x[:, m:-m, m:-m], y[:, m:-m, m:-m]
        print(f"K1 bits [{tag}] {part}: interior {bits_differ(xi, yi)} of "
              f"{xi.numel()} px differ, whole image {bits_differ(x, y)} of "
              f"{x.numel()}", flush=True)


def k4_slots(tag, a, b):
    """(hypothesis, root) slots of two K4 outputs that differ."""
    za, zb = (torch.where(o[3], 1.0 / torch.where(o[2].abs() > 1e-12, o[2],
                                                   1.0), o[2]) for o in (a, b))
    has = a[4] != b[4]
    both = a[4] & b[4]
    moved = both & ((za - zb).abs() > 1e-6)
    same = both & (a[0] == b[0]) & (a[1] == b[1]) & (a[2] == b[2])
    print(f"K4 slots [{tag}]: has_root differs on {int(has.sum())}, |dz| > "
          f"1e-6 on {int(moved.sum())} of {int(both.sum())} rooted on both; "
          f"x, y, r bit-equal on {int(same.sum())}", flush=True)


def k5_slots(tag, a, b):
    ends = (a[0] != b[0]) | (a[1] != b[1])
    print(f"K5 slots [{tag}]: has_root differs on {int((a[2] != b[2]).sum())}"
          f", endpoints differ on {int(ends.sum())} of {a[0].numel()}",
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", metavar="DIR",
                    help="another copy of csrc/ to build, time and compare")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_breakdown: needs a CUDA card")
    dev = torch.device("cuda")
    full_precision()
    kernels.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)
    for name in LIBS:
        print_ptxas(name, kernels.PTXAS_LOG.get(name, ""))
        print_sass(name, kernels._lib_path(name))
    other = build_against(args.against) if args.against else None

    cfg = EstimatorConfig()
    o = cfg.orb
    frames, K, _ = make_sequence(9, 376, 1241, seed=0)
    imgs = torch.from_numpy(frames).to(dev)
    atlas = atlas_keypoints(imgs, o.nfeatures, o.nlevels, o.scale_factor,
                            o.fast_threshold, o.max_kpts)["atlas"].contiguous()
    with torch.no_grad():
        dets = detect_features(imgs, cfg)
    c_main = chip_smoke._main_path_coeffs(torch, dets, cfg, K, dev)
    c_exact = chip_smoke._exact_minimal_coeffs(np, torch, fp, 2048, dev)
    print(f"inputs: atlases {tuple(atlas.shape)}, K4 main path "
          f"{tuple(c_main.shape)}, exact {tuple(c_exact.shape)}", flush=True)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    calls = {
        "K1 fast_harris":
            lambda: fast_harris_rank_map(atlas, o.fast_threshold),
        "K4 five_point_roots (main path)":
            lambda: fp.solve_roots_polished(c_main),
        "K4 five_point_roots (exact)":
            lambda: fp.solve_roots_polished(c_exact),
        "K5 root_brackets (exact)": lambda: fp.find_root_brackets(c_exact),
    }
    plain = fast_harris_rank_map_plain(atlas, o.fast_threshold)
    mine = {k: fn() for k, fn in calls.items()}
    k1_bits("repo vs plain", mine["K1 fast_harris"], plain)
    px = atlas.numel()
    # thread-instructions per pixel K1's device time affords at full issue
    # (132 SMs x 4 schedulers x 32 lanes per clock) at the SM's max clock
    clk = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout
    print(f"SM clock MHz (now, max): {clk.strip()}", flush=True)
    mhz = float(clk.split(",")[1]) if "," in clk else 1980.0

    def timed(name, fn):
        r = measure(name, fn, flush)
        if name.startswith("K1"):
            print(f"{name} issue budget: "
                  f"{r['device'] * 1e-3 * mhz * 1e6 * 132 * 128 / px:.1f} "
                  f"thread-instructions per pixel at {mhz:.0f} MHz over "
                  f"{px} px", flush=True)

    if other is None:
        for k, fn in calls.items():
            timed(k, fn)
        return

    mine_libs = {n: kernels._LIBS[n] for n in LIBS}

    def use(libs):
        kernels._LIBS.update(libs)

    use(other)
    theirs = {k: fn() for k, fn in calls.items()}
    k1_bits("against vs plain", theirs["K1 fast_harris"], plain)
    k1_bits("repo vs against", mine["K1 fast_harris"],
            theirs["K1 fast_harris"])
    for k in calls:
        if k.startswith("K4"):
            k4_slots(f"repo vs against, {k[20:]}", mine[k], theirs[k])
    k5_slots("repo vs against, exact", mine["K5 root_brackets (exact)"],
             theirs["K5 root_brackets (exact)"])
    for k, fn in calls.items():
        for tag, libs in (("against", other), ("repo", mine_libs),
                          ("repo", mine_libs), ("against", other)):
            use(libs)
            timed(f"{k} [{tag}]", fn)
    use(mine_libs)


if __name__ == "__main__":
    main()
