#!/usr/bin/env python3
"""Where K3's and K6-Hamming's time goes on the card, at one chunk's
shapes (8 pairs of 4096 x 4096 {0,1} descriptors, 5% invalid, made from a
seed), beside the library call chip_smoke.py times (bf16 `torch.matmul`
of the same Gram product).

    python3 scripts/hamming_breakdown.py     # needs a CUDA card and nvcc

For each of K3, K6-Hamming and the library call it prints:
  - flushed: mean CUDA-event time of one call with the L2 flushed before
    it (chip_smoke.py's measurement; host time between the events counts
    when the card waits for the launch);
  - queued: mean CUDA-event time per call over 20 calls queued back to
    back (the host's launch work hides behind the card's), and the host's
    own time per call in that loop;
  - device: per-kernel device time from torch.profiler over 20 calls
    (each device activity of the wrapper: the main kernel, and K3's
    memset of its column keys and finalize pass).
"""

import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rpe_tpu_torch.ops import kernels  # noqa: E402
from rpe_tpu_torch.ops.match import mutual_nn_hamming, row_top2  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("hamming_breakdown: needs a CUDA card")
    dev = torch.device("cuda")
    kernels.build_all()
    g = np.random.default_rng(0)
    p, n = 8, 4096
    b1, b2 = (torch.from_numpy(g.uniform(size=(p, n, 256)) < 0.5).to(
        torch.uint8).to(dev) for _ in range(2))
    v1, v2 = (torch.from_numpy(g.uniform(size=(p, n)) < 0.95).to(dev)
              for _ in range(2))
    a16 = b1.to(torch.bfloat16)
    c16 = b2.to(torch.bfloat16).transpose(-1, -2)
    flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    calls = {
        "K3 match_hamming": lambda: mutual_nn_hamming(b1, b2, v1, v2),
        "K6 row_top2_hamming": lambda: row_top2(b1, b2, v1, v2, "hamming"),
        "library bf16 matmul": lambda: torch.matmul(a16, c16),
    }
    for name, fn in calls.items():
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


if __name__ == "__main__":
    main()
