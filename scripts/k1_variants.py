#!/usr/bin/env python3
"""Build variants of K1's source (csrc/fast_harris.cu or edited copies of
it) and time them against each other on the chunk's atlases, each held bit
for bit to the plain version.

    python3 scripts/k1_variants.py NAME=SOURCE[:DEFINE,...] ...
    # e.g. repo=rpe_tpu_torch/csrc/fast_harris.cu
    #      old=/path/to/parent/fast_harris.cu  try=/path/to/copy.cu:TH=8

Needs a CUDA card and nvcc. Each source is compiled with the repo's flags
for K1 (ops/kernels.py, `-fmad=false`) plus its -D defines, must export
`fast_harris_launch` with the repo's signature, and runs on the 9 atlases
(9, 3200, 1280) of `make_sequence(9, 376, 1241, seed=0)`. For each variant
it prints the ptxas lines, whether rank and blur are bit-equal to the plain
version over the interior (8 px from the edges) and, over the whole image,
to the plain version on the wrap-padded atlas, and the queued time per call
(CUDA events around 30 calls back to back), three times in turns
(forward, backward, forward).
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

from kernel_breakdown import build_parallel  # noqa: E402
from rpe_tpu_torch.config import EstimatorConfig  # noqa: E402
from rpe_tpu_torch.ops import kernels  # noqa: E402
from rpe_tpu_torch.ops.fast import _GAUSS7, \
    fast_harris_rank_map_plain  # noqa: E402
from rpe_tpu_torch.ops.orb import atlas_keypoints  # noqa: E402
from rpe_tpu_torch.utils.synthetic import make_sequence  # noqa: E402


def build(variants):
    """{name: launcher} for NAME=SOURCE[:DEFINES] strings, compiled in
    parallel into csrc/build/variants/."""
    specs = {}
    for spec in variants:
        name, rest = spec.split("=", 1)
        src, _, defs = rest.partition(":")
        specs[name] = ("fast_harris", Path(src).resolve(),
                       [d for d in defs.split(",") if d])
    libs = {}
    for name, (lib, _) in build_parallel(
            specs, kernels.BUILD_DIR / "variants", "k1_variants").items():
        fn = lib.fast_harris_launch
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def main():
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        sys.exit(__doc__ if len(sys.argv) < 2
                 else "k1_variants: needs a CUDA card")
    dev = torch.device("cuda")
    libs = build(sys.argv[1:])
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"nvidia-smi: {smi.stdout.strip()}", flush=True)
    o = EstimatorConfig().orb
    frames, _, _ = make_sequence(9, 376, 1241, seed=0)
    atlas = atlas_keypoints(torch.from_numpy(frames).to(dev), o.nfeatures,
                            o.nlevels, o.scale_factor, o.fast_threshold,
                            o.max_kpts)["atlas"].contiguous()
    m = 8
    rp, bp = fast_harris_rank_map_plain(atlas, o.fast_threshold)
    pad = torch.nn.functional.pad(atlas[:, None], (m,) * 4, mode="circular")
    rw, bw = (x[:, m:-m, m:-m] for x in fast_harris_rank_map_plain(
        pad[:, 0], o.fast_threshold))
    del pad
    f, h, w = atlas.shape
    rk, bk = torch.empty_like(atlas), torch.empty_like(atlas)
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn):
        rc = fn(atlas.data_ptr(), rk.data_ptr(), bk.data_ptr(), f, h, w,
                o.fast_threshold, 0.04, _GAUSS7, stream)
        if rc != 0:
            sys.exit(f"k1_variants: launch failed (cudaError {rc})")

    for name, fn in libs.items():
        rk.fill_(7.0)
        bk.fill_(7.0)
        call(fn)
        torch.cuda.synchronize()
        inner = bool(torch.equal(rk[:, m:-m, m:-m], rp[:, m:-m, m:-m])
                     and torch.equal(bk[:, m:-m, m:-m], bp[:, m:-m, m:-m]))
        whole = bool(torch.equal(rk, rw) and torch.equal(bk, bw))
        print(f"{name}: bit-equal interior {inner}, whole image (wrapped) "
              f"{whole}", flush=True)

    def queued(fn, n=30):
        call(fn)
        torch.cuda.synchronize()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(n):
            call(fn)
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / n

    times = {k: [] for k in libs}
    order = list(libs)
    for rep in range(3):
        for k in (order if rep % 2 == 0 else order[::-1]):
            times[k].append(queued(libs[k]))
    for k, v in times.items():
        print(f"{k}: queued ms per call {[round(x, 4) for x in v]} "
              f"({atlas.numel()} px)", flush=True)


if __name__ == "__main__":
    main()
