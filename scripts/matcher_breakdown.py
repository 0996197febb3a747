#!/usr/bin/env python3
"""Where the matchers' time goes on the card, at one chunk's shapes (8 pairs
of 4096 x 4096 descriptors, made from a seed), beside the library call
chip_smoke.py times for the same Gram product.

    python3 scripts/matcher_breakdown.py               # both norms
    python3 scripts/matcher_breakdown.py --norm l2     # K7, K6-L2 only
    python3 scripts/matcher_breakdown.py --norm hamming

Needs a CUDA card and nvcc. --norm hamming: K3 and K6-Hamming on {0,1}
descriptors (5% invalid) beside the bf16 `torch.matmul`; --norm l2: K7 and
K6-L2 on SIFT-like unit-norm float descriptors (`utils/synthetic.
float_descriptors`, 10% invalid) beside the float32 `torch.matmul` with TF32
off. For each call it prints:
  - flushed: mean CUDA-event time of one call with the L2 flushed before
    it (chip_smoke.py's measurement; host time between the events counts
    when the card waits for the launch);
  - queued: mean CUDA-event time per call over 20 calls queued back to
    back (the host's launch work hides behind the card's), and the host's
    own time per call in that loop;
  - device: per-kernel device time from torch.profiler over 20 calls
    (each device activity of the wrapper: the main kernel and, for K7 and
    K6-L2, the split pass; for K3 and K7 also the memset of the column keys
    and the finalize pass).
"""

import argparse
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rpe_tpu_torch.ops import kernels  # noqa: E402
from rpe_tpu_torch.ops.match import mutual_nn_hamming, mutual_nn_l2, \
    row_top2  # noqa: E402
from rpe_tpu_torch.utils.device import full_precision  # noqa: E402
from rpe_tpu_torch.utils.synthetic import float_descriptors  # noqa: E402

P, N = 8, 4096


def hamming_calls(dev):
    g = np.random.default_rng(0)
    b1, b2 = (torch.from_numpy(g.uniform(size=(P, N, 256)) < 0.5).to(
        torch.uint8).to(dev) for _ in range(2))
    v1, v2 = (torch.from_numpy(g.uniform(size=(P, N)) < 0.95).to(dev)
              for _ in range(2))
    a16 = b1.to(torch.bfloat16)
    c16 = b2.to(torch.bfloat16).transpose(-1, -2)
    return {
        "K3 match_hamming": lambda: mutual_nn_hamming(b1, b2, v1, v2),
        "K6 row_top2_hamming": lambda: row_top2(b1, b2, v1, v2, "hamming"),
        "library bf16 matmul": lambda: torch.matmul(a16, c16),
    }


def l2_calls(dev):
    d1, d2, v1, v2 = (torch.from_numpy(a).to(dev) for a in float_descriptors(
        0, N, N, pairs=P))
    d2t = d2.transpose(-1, -2)
    return {
        "K7 match_l2": lambda: mutual_nn_l2(d1, d2, v1, v2),
        "K6 row_top2_l2": lambda: row_top2(d1, d2, v1, v2, "l2"),
        "library float32 matmul": lambda: torch.matmul(d1, d2t),
    }


def breakdown(name, fn, flush):
    fn()
    torch.cuda.synchronize()
    tot = 0.0
    for _ in range(10):
        flush.zero_()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        tot += s.elapsed_time(e)
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
    dev_ms = {}
    for ev in prof.events():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            dev_ms[ev.name] = (dev_ms.get(ev.name, 0.0)
                               + ev.time_range.elapsed_us() / 1e3 / 20)
    parts = ", ".join(f"{k[:60]} {v:.4f}" for k, v in sorted(
        dev_ms.items(), key=lambda kv: -kv[1]))
    print(f"{name}: flushed {tot / 10:.4f} ms, queued {queued:.4f} ms, "
          f"host {host:.4f} ms per call, "
          f"device {sum(dev_ms.values()):.4f} ms ({parts})", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--norm", choices=("hamming", "l2", "both"),
                    default="both")
    norm = ap.parse_args().norm
    if not torch.cuda.is_available():
        sys.exit("matcher_breakdown: needs a CUDA card")
    dev = torch.device("cuda")
    full_precision()
    kernels.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    calls = {}
    if norm in ("hamming", "both"):
        calls.update(hamming_calls(dev))
    if norm in ("l2", "both"):
        calls.update(l2_calls(dev))
    for name, fn in calls.items():
        breakdown(name, fn, flush)


if __name__ == "__main__":
    main()
