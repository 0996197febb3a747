"""The control of each configuration's check, and the program's readings
that its limits are set from.

    python3 posebench/control.py --workload orb4000.kitti_b128 \
        --seeds 11 12 13 --seconds 3

runs, in one process, a short window of the cell at its own load for each
seed and reads every number of the check twice on the same sample: once on
what the program returned, once on the control -- the plain reference put
in the program's place and computed in bfloat16, the precision below the
configuration's float32 (reference/*.py `control_*`). One JSON line per seed
goes to standard output, and all of them to chiprun_out/control_<cell>.jsonl
when that directory exists. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None, device=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT))
    import harness
    import manifest
    import torch

    cell = manifest.Cell(manifest.load(ROOT), args.workload, ROOT)
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 1
        device = "cuda:0"
    out_dir = ROOT / "chiprun_out"
    lines = []
    for seed in args.seeds:
        r = harness.run(cell, seed, args.seconds, False, device,
                        time.perf_counter(),
                        log=lambda m: print(m, file=sys.stderr), control=True)
        line = {"workload": cell.name, "seed": seed,
                "correct": r["correct"], "device": r["device"],
                "program": {k: v["value"] for k, v in r["checks"].items()},
                "control": {k: r["control"][k] for k in r["checks"]}}
        lines.append(line)
        print(json.dumps(line), flush=True)
    if out_dir.is_dir():
        with open(out_dir / f"control_{cell.name}.jsonl", "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
