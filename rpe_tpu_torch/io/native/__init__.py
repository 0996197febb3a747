"""ctypes binding and first-use build of the native batched image decoder
(port of rpe_tpu/io/native/__init__.py).

The C++ side (loader.cpp, beside this file) exposes a C ABI (rpe_image_dims,
rpe_decode_batch). It is compiled with g++ on first use into
rpe_tpu_torch/csrc/build/ (listed in .gitignore) under a name that hashes
the source and the flags, as ops/kernels.py names the CUDA libraries. A
failed build raises: nothing falls back silently. `RPE_NO_NATIVE_LOADER=1`
is the one explicit way to decode without it (io/image_loader.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "csrc" / "build"
GXX_FLAGS = ["-O2", "-shared", "-fPIC"]
_lib = None


class UnsupportedImage(RuntimeError):
    """A JPEG variant the native decoder does not cover (e.g. progressive)."""


def _lib_path() -> Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS + ["-lz"]).encode())
    return BUILD_DIR / f"librpe_loader_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}")
    cmd = ["g++", *GXX_FLAGS, str(_SRC), "-lz", "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError("building the native image decoder needs g++ "
                           "on PATH") from e
    if r.returncode != 0:
        raise RuntimeError(f"native image decoder build failed "
                           f"(g++ exit {r.returncode}):\n{r.stderr}")
    os.replace(tmp, out)


def load_library() -> ctypes.CDLL:
    """Build (once per source) and load the decoder library."""
    global _lib
    if _lib is not None:
        return _lib
    so = _lib_path()
    if not so.exists():
        _build(so)
    lib = ctypes.CDLL(str(so))
    lib.rpe_image_dims.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int),
                                   ctypes.POINTER(ctypes.c_int)]
    lib.rpe_image_dims.restype = ctypes.c_int
    lib.rpe_decode_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
        ctypes.c_int,
    ]
    lib.rpe_decode_batch.restype = ctypes.c_int
    _lib = lib
    return lib


def _dims(lib, path: str):
    """(W, H) of one PNG or baseline JPEG; UnsupportedImage for a JPEG
    variant the decoder lacks, FileNotFoundError if unreadable."""
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.rpe_image_dims(path.encode(), ctypes.byref(w), ctypes.byref(h))
    if rc == 2:
        raise UnsupportedImage(
            f"unsupported JPEG variant (native decoder): {path}")
    if rc != 0:
        raise FileNotFoundError(f"Could not read image from: {path}")
    return w.value, h.value


def decode_batch(paths, to_gray: bool = True, nthreads: int = 0) -> np.ndarray:
    """Decode same-size images into one array: (N, H, W) uint8 grayscale or
    (N, H, W, 3) uint8 BGR. FileNotFoundError on an unreadable or
    mismatched file, UnsupportedImage on a JPEG variant the decoder lacks."""
    lib = load_library()
    paths = [str(p) for p in paths]
    n = len(paths)
    if n == 0:
        raise ValueError("empty path list")
    W, H = _dims(lib, paths[0])
    out = np.empty((n, H, W, 3) if not to_gray else (n, H, W), dtype=np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    rc = lib.rpe_decode_batch(
        arr, n, W, H, out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        1 if to_gray else 0, nthreads)
    if rc != 0:
        _dims(lib, paths[rc - 1])   # raises UnsupportedImage where it applies
        raise FileNotFoundError(f"Could not read image from: {paths[rc - 1]}")
    return out
