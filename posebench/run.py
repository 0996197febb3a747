"""The benchmark of rpe_tpu_torch: one run of one cell.

    python3 posebench/run.py --workload orb4000.kitti_b128 --seed 7 \
        --seconds 20 --trace 0

from the root of a checkout on a machine with a CUDA card. The last line
of standard output is one JSON object (correct, attempted, failed, metrics,
device, with --trace 1 also breakdown, and last checks: each compared number
with its limit); the same numbers end standard error. With --trace 0 the
metrics are the cell's end-to-end ones, with --trace 1 its per-layer ones.

Exits non-zero and prints no result without a card (or with fewer than the
cell asks for), without the program beside the benchmark, or when a module
of JAX or of the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None) -> int:
    """One run; `device` other than None (a test's "cpu") skips the look
    for a card."""
    args = parse(argv)
    sys.path.insert(0, str(HERE))
    import harness
    import manifest

    cell = manifest.Cell(manifest.load(ROOT), args.workload, ROOT)
    # the configuration is run as its file states it: no switch of the
    # program's environment may change its path
    for k in [k for k in os.environ if k.startswith("RPE_")]:
        del os.environ[k]
    import torch

    if device is None:
        if not torch.cuda.is_available():
            log("no CUDA device: the benchmark measures the card")
            return 1
        if torch.cuda.device_count() < cell.chips:
            log(f"{cell.name} needs {cell.chips} cards, "
                f"{torch.cuda.device_count()} present")
            return 1
        device = "cuda:0"
    sys.path.insert(0, str(ROOT))
    try:
        import rpe_tpu_torch  # noqa: F401
    except ImportError as e:
        log(f"the program rpe_tpu_torch is not beside the benchmark: {e}")
        return 1
    log(f"imports and CUDA start {time.perf_counter() - T_START:.3f} s")
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device, T_START, log=log)
    line = harness.result_line(result)
    log("checks: " + ", ".join(f"{k} {v['value']!r} <= {v['limit']!r}"
                               for k, v in result["checks"].items()))
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
