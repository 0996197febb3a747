"""Build, load and count the port's hand-written CUDA kernels.

Each source in rpe_tpu_torch/csrc/ is a plain `extern "C"` launcher around
its kernel(s), compiled for Hopper (`sm_90a`) by `nvcc` into its own shared
library and loaded with ctypes. All sources are compiled in parallel (one
`nvcc` process per source, started together) on first use; the libraries go
to rpe_tpu_torch/csrc/build/ (listed in .gitignore) under a name that hashes
the source, the shared headers (csrc/*.cuh) and the flags, so an unchanged
source is not rebuilt within a checkout.

No `--use_fast_math`: BRIEF rounding and the 5-point sign tests rely on IEEE
`sqrtf`, division and `rintf`. The FAST/Harris and extraction kernels also
turn off FMA contraction (`-fmad=false`) so their arithmetic is the same
sequence of roundings as their plain PyTorch versions, and so does SIFT's
(P3, P4), whose only difference from its plain version is then the order
and precision of its sums. P1 (five_point_coeffs.cu) is built the same way
and writes each of its fused multiply-adds as `__fma_rn`, so the source
alone fixes how every output rounds. P5-P8 (small_solvers.cu) are built
with -fmad=false too, so that each of their float32 operations rounds once,
as the eager launch it replaces does.

`LAUNCHES` counts, per kernel, the launches its wrapper made; the wrappers
increment it right after a launch succeeds and nowhere else. A source may
hold more than one kernel (`KERNELS` maps each kernel to its source): K6's
two modes count under their own names, beside K3 and K7; K12 beside K2;
K5 beside K4; K8, K9 and K10 in one source. P1 and P2 have no TPU kernel
of their own: they take the place of PyTorch's batched products in the
geometry layer, whose summation order on the card depends on the batch
(geometry/five_point.py `constraint_coeffs`, geometry/_products.py); P3
and P4 likewise take the place of SIFT's sampling matmuls, histograms and
norms (ops/sift.py `orientation_hist`, `descriptor`); P5-P8 take the
place of RANSAC's eager chains of small per-matrix solvers and of the
threefry hash (geometry/eig.py, geometry/epipolar.py `frame_rotations`,
rng.py), each one launch where its plain version makes hundreds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "build"

# library name -> (source file, extra nvcc flags)
SOURCES = {
    "fast_harris": ("fast_harris.cu", ["-fmad=false"]),
    "extract_brief": ("extract_brief.cu", ["-fmad=false"]),
    "match_hamming": ("match_hamming.cu", []),
    "five_point_roots": ("five_point_roots.cu", []),
    "match_l2": ("match_l2.cu", []),
    "extract_patches": ("extract_patches.cu", ["-fmad=false"]),
    "five_point_coeffs": ("five_point_coeffs.cu", ["-fmad=false"]),
    "fixed_order": ("fixed_order.cu", []),
    "sift_sample": ("sift_sample.cu", ["-fmad=false"]),
    "small_solvers": ("small_solvers.cu", ["-fmad=false"]),
}

# kernel name (as counted in LAUNCHES) -> library it launches from
KERNELS = {
    "fast_harris": "fast_harris",              # K1
    "extract_brief": "extract_brief",          # K2
    "match_hamming": "match_hamming",          # K3
    "five_point_roots": "five_point_roots",    # K4
    "row_top2_hamming": "match_hamming",       # K6, Hamming mode
    "row_top2_l2": "match_l2",                 # K6, L2 mode
    "match_l2": "match_l2",                    # K7
    "root_brackets": "five_point_roots",       # K5
    "extract_patches": "extract_patches",      # K8
    "extract_patches_moments": "extract_patches",  # K9
    "extract_patches_t": "extract_patches",    # K10
    "extract_brief_binned": "extract_brief",   # K12
    "five_point_coeffs": "five_point_coeffs",  # P1 (port-only)
    "fixed_order_bmm": "fixed_order",          # P2 (port-only)
    "sift_orientation_hist": "sift_sample",    # P3 (port-only)
    "sift_descriptor": "sift_sample",          # P4 (port-only)
    "smallest_eigvec_sym": "small_solvers",    # P5 (port-only)
    "eigh3x3_desc": "small_solvers",           # P6 (port-only)
    "essential_frame": "small_solvers",        # P7 (port-only)
    "threefry2x32": "small_solvers",           # P8 (port-only)
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# P1 launches once per estimator call of the 5-point solver, P2 once at
# each call of the geometry's fixed-order helpers (geometry/_products.py
# `matmul`, `row_sum`, and `matmuls`, which takes up to four products in
# one launch), P5-P8 once at each call of geometry/eig.py
# `smallest_eigvec_sym` and `eigh3x3_desc`, geometry/epipolar.py
# `frame_rotations` and rng.py `threefry2x32`: numbers fixed by the path
# (counted on the CPU by tests/test_torch_batch_invariance.py)
P2_PER_CALL = 43            # default RANSAC: 5-point, DEGENSAC, 2 refits
P2_PER_CALL_LO = 63         # RansacConfig(lo=True)
P2_PER_CALL_8PT = 44        # RansacConfig(solver="8pt"): no P1 (and no K4)
P2_PAIRS_2D = 82            # estimate_pairs_2d on a (1, 2) mesh: RANSAC on
                            # each hyp shard, recover_pose once
# P5, P6, P7, P8 per estimator call, by path (RANSAC's, then recoverPose's
# one eigendecomposition and frame)
SMALL_SOLVERS_PER_CALL = {
    "5pt": {"smallest_eigvec_sym": 6, "eigh3x3_desc": 10,
            "essential_frame": 10, "threefry2x32": 5},
    "lo": {"smallest_eigvec_sym": 11, "eigh3x3_desc": 15,
           "essential_frame": 15, "threefry2x32": 7},
    "8pt": {"smallest_eigvec_sym": 7, "eigh3x3_desc": 10,
            "essential_frame": 10, "threefry2x32": 5},
}
SMALL_SOLVERS_PAIRS_2D = {"smallest_eigvec_sym": 12, "eigh3x3_desc": 19,
                          "essential_frame": 19, "threefry2x32": 12}
_P2 = {"5pt": P2_PER_CALL, "lo": P2_PER_CALL_LO, "8pt": P2_PER_CALL_8PT}


def geometry_path(ransac) -> str:
    """The geometry's launch path of RansacConfig `ransac`: "8pt" for the
    8-point solver, "lo" for LO-RANSAC, else "5pt"."""
    return "8pt" if ransac.solver == "8pt" else "lo" if ransac.lo else "5pt"


def geometry_launches(calls: int, path: str = "5pt") -> dict[str, int]:
    """P1's, P2's and P5-P8's launches in `calls` estimator calls on
    `path` (`geometry_path`; P1 only where the 5-point solver draws the
    hypotheses)."""
    out = {"fixed_order_bmm": calls * _P2[path]}
    out |= {k: calls * n for k, n in SMALL_SOLVERS_PER_CALL[path].items()}
    if path != "8pt":
        out["five_point_coeffs"] = calls
    return out


def sift_launches(h: int, w: int, cfg, calls: int = 1,
                  upscale_first: bool = True) -> dict[str, int]:
    """P3's and P4's launches in `calls` SIFT detections of h x w frames
    (SiftConfig `cfg`): one each per octave that ops/sift.py builds (5 at
    1241x376, 3 at 120x400)."""
    from .sift import octave_sizes

    n = len(octave_sizes(h, w, cfg.noctaves, upscale_first)) * calls
    return {"sift_orientation_hist": n, "sift_descriptor": n}


LAUNCHES = {name: 0 for name in KERNELS}
PTXAS_LOG: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (CUDA_HOME or nvcc on PATH)")
    return found


def _lib_path(name: str) -> Path:
    src, extra = SOURCES[name]
    h = hashlib.sha256((CSRC / src).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS + extra).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every missing library (in parallel) and load all of them."""
    missing = [n for n in SOURCES if n not in _LIBS]
    if not missing:
        return _LIBS
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in missing:
        out = _lib_path(name)
        if out.exists():
            continue
        src, extra = SOURCES[name]
        tmp = out.with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc_path(), *NVCC_FLAGS, *extra, "-o", str(tmp),
               str(CSRC / src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (p, tmp, out) in procs.items():
        log, _ = p.communicate()
        PTXAS_LOG[name] = log
        if p.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {p.returncode}) ---\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    for name in missing:
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS


def lib(name: str) -> ctypes.CDLL:
    return build_all()[name]


def check(name: str, rc: int) -> None:
    """Raise on a non-zero cudaError_t returned by kernel `name`'s
    launcher, else count the launch."""
    if rc != 0:
        err = lib(KERNELS[name]).rpe_cuda_error_string
        err.restype = ctypes.c_char_p
        err.argtypes = [ctypes.c_int]
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"{err(rc).decode()} (cudaError {rc})")
    LAUNCHES[name] += 1


# The launchers' host cost is part of every kernel's time on a path whose
# device waits for the host, so these take the shortest calls: the raw
# stream handle (what `torch.cuda.current_stream(dev).cuda_stream` returns,
# without building a Stream object) and plain integers, which ctypes
# passes as c_void_p arguments.
def stream_ptr(t) -> int:
    return torch._C._cuda_getCurrentRawStream(t.get_device())


def ptr(t) -> int:
    return t.data_ptr()


def launch(name: str, fn, t, *args) -> None:
    """Launch kernel `name` through its ctypes launcher `fn(*args, stream)`
    on the device of `t` (the tensors `require_cuda` held to one device),
    on that device's current stream, and count it.

    The launcher runs on the calling thread's current device, so a launch
    for tensors on another card enters their device for the call. When
    the device is already current -- the common case, one card -- that
    costs one integer compare and no context manager."""
    d = t.get_device()
    if d == torch._C._cuda_getDevice():
        rc = fn(*args, torch._C._cuda_getCurrentRawStream(d))
    else:
        with torch.cuda.device(d):
            rc = fn(*args, torch._C._cuda_getCurrentRawStream(d))
    check(name, rc)


def require_cuda(name: str, **tensors) -> None:
    """Wrapper precondition: every tensor on one CUDA device, contiguous."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: tensors must share one CUDA device, got "
                         f"{ {k: str(t.device) for k, t in tensors.items()} }")
    for k, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {k} must be contiguous")
