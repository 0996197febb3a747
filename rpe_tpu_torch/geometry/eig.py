"""Batched small-matrix eigensolvers in closed form (port of
rpe_tpu/geometry/eig.py).

  * `eigh3x3_desc`: trigonometric (Cardano) eigenvalues + cross-product
    eigenvectors for symmetric 3x3.
  * `smallest_eigvec_sym`: unrolled Cholesky + inverse iteration for the
    eigenvector of the smallest eigenvalue of a symmetric PSD matrix.

The closed forms are kept (not torch.linalg.eigh) so results follow the
reference's arithmetic. Both batch over leading dimensions. CUDA tensors
launch P6 and P5 (csrc/small_solvers.cu), a thread per matrix, which give
the plain versions' eager bits on the card in one launch where those make
hundreds; CPU tensors take the plain versions.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..ops import kernels

_EPS = 1e-20


def _cross(a, b):
    return torch.stack([
        a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
    ], dim=-1)


def eigh3x3_desc(A):
    """Symmetric 3x3 eigendecomposition, descending eigenvalues.

    A: (..., 3, 3) float32. Returns (w (..., 3) descending, V (..., 3, 3)
    orthonormal columns, det(V) = +1), as `eigh3x3_desc_plain`. CUDA
    tensors launch P6; CPU tensors take the plain version.
    """
    if A.device.type == "cpu":
        return eigh3x3_desc_plain(A)
    A = _matrices("eigh3x3_desc", A, (3,))
    batch = A.shape[:-2]
    w = torch.empty((*batch, 3), dtype=torch.float32, device=A.device)
    V = torch.empty((*batch, 3, 3), dtype=torch.float32, device=A.device)
    problems = w.numel() // 3
    if problems:
        kernels.launch("eigh3x3_desc", _launchers(kernels.lib(
            "small_solvers"))[0], A, A.data_ptr(), w.data_ptr(),
            V.data_ptr(), problems)
    return w, V


def eigh3x3_desc_plain(A):
    """Plain version of P6: `eigh3x3_desc` in eager PyTorch."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12))
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, _EPS))
    ip = 1.0 / p
    c00, c11, c22 = b00 * ip, b11 * ip, b22 * ip
    c01, c02, c12 = a01 * ip, a02 * ip, a12 * ip
    r = 0.5 * (c00 * (c11 * c22 - c12 * c12)
               - c01 * (c01 * c22 - c12 * c02)
               + c02 * (c01 * c12 - c11 * c02))
    r = torch.clamp(r, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    w0 = q + 2.0 * p * torch.cos(phi)                        # largest
    w2 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)  # smallest
    w1 = 3.0 * q - w0 - w2

    def eigvec(lam):
        r0 = torch.stack([a00 - lam, a01, a02], dim=-1)
        r1 = torch.stack([a01, a11 - lam, a12], dim=-1)
        r2 = torch.stack([a02, a12, a22 - lam], dim=-1)
        c01_ = _cross(r0, r1)
        c02_ = _cross(r0, r2)
        c12_ = _cross(r1, r2)
        n01 = (c01_ * c01_).sum(-1)
        n02 = (c02_ * c02_).sum(-1)
        n12 = (c12_ * c12_).sum(-1)
        best12 = (n12 >= n01) & (n12 >= n02)
        best02 = (n02 >= n01) & ~best12
        v = torch.where(best12[..., None], c12_,
                        torch.where(best02[..., None], c02_, c01_))
        n = torch.sqrt(torch.clamp_min((v * v).sum(-1, keepdim=True), _EPS))
        return v / n

    # v2 (smallest, well separated for essential matrices) first; v0 is
    # orthogonalized against it
    v2 = eigvec(w2)
    v0 = eigvec(w0)
    v0 = v0 - (v2 * v0).sum(-1, keepdim=True) * v2
    n0 = torch.sqrt(torch.clamp_min((v0 * v0).sum(-1, keepdim=True), _EPS))
    ref = torch.zeros_like(v2)
    ref[..., 0] = 1.0
    alt = torch.zeros_like(v2)
    alt[..., 1] = 1.0
    ref = torch.where((v2 * ref).sum(-1, keepdim=True).abs() > 0.9, alt, ref)
    fallback = ref - (v2 * ref).sum(-1, keepdim=True) * v2
    fallback = fallback / torch.sqrt(torch.clamp_min(
        (fallback * fallback).sum(-1, keepdim=True), _EPS))
    degenerate = n0[..., 0] < 1e-6
    v0 = torch.where(degenerate[..., None], fallback, v0 / n0)
    v1 = _cross(v2, v0)

    w = torch.stack([w0, w1, w2], dim=-1)
    V = torch.stack([v0, v1, v2], dim=-1)
    return w, V


def _cholesky_unrolled(A, n: int, jitter):
    """Unrolled dense Cholesky for small n; A (..., n, n) symmetric PD."""
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j] + jitter if i == j else A[..., i, j]
            for k_ in range(j):
                s = s - L[i][k_] * L[j][k_]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp_min(s, _EPS))
            else:
                L[i][j] = s / L[j][j]
    return L


def _chol_solve_unrolled(L, b, n: int):
    """Solve L L^T x = b with unrolled triangular solves; b: list of (...,)."""
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k_ in range(i):
            s = s - L[i][k_] * y[k_]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k_ in range(i + 1, n):
            s = s - L[k_][i] * x[k_]
        x[i] = s / L[i][i]
    return x


def smallest_eigvec_sym(A, iters: int = 3):
    """Eigenvector of the smallest eigenvalue of symmetric PSD A (..., n, n)
    float32: shifted inverse iteration on one unrolled Cholesky
    factorization, as `smallest_eigvec_sym_plain`. CUDA tensors launch P5,
    for n = 9 (the 8-point and DLT normal matrices) and n = 10 (K4's plain
    version); CPU tensors take the plain version."""
    if A.device.type == "cpu":
        return smallest_eigvec_sym_plain(A, iters)
    A = _matrices("smallest_eigvec_sym", A, (9, 10))
    n = A.shape[-1]
    out = torch.empty(A.shape[:-1], dtype=torch.float32, device=A.device)
    problems = out.numel() // n
    if problems:
        kernels.launch("smallest_eigvec_sym", _launchers(kernels.lib(
            "small_solvers"))[1], A, A.data_ptr(), out.data_ptr(), problems,
            n, int(iters))
    return out


def _matrices(name, A, sizes):
    """P5's and P6's precondition: float32 (..., n, n) with n in `sizes` on
    a CUDA device; returns A contiguous (P5's trace sums the diagonal in
    the order ATen takes for a matrix whose batch strides exceed its
    diagonal's, as a contiguous one's do)."""
    n = A.shape[-1]
    if A.dim() < 2 or A.shape[-2] != n or n not in sizes \
            or A.dtype != torch.float32:
        raise ValueError(f"{name}: want float32 (..., n, n), n in {sizes}, "
                         f"got {A.dtype} {tuple(A.shape)}")
    A = A.contiguous()
    kernels.require_cuda(name, A=A)
    return A


@functools.lru_cache(maxsize=None)
def _launchers(lib):
    """P6's and P5's launchers with their argument types set, once per
    loaded library."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    eigh = lib.eigh3x3_launch
    eigh.argtypes = [p, p, p, i64, p]
    eigh.restype = i32
    vec = lib.smallest_eigvec_launch
    vec.argtypes = [p, p, i64, i32, i32, p]
    vec.restype = i32
    return eigh, vec


def smallest_eigvec_sym_plain(A, iters: int = 3):
    """Plain version of P5: `smallest_eigvec_sym` in eager PyTorch."""
    n = A.shape[-1]
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
    jitter = 1e-7 * tr + 1e-12
    L = _cholesky_unrolled(A, n, jitter)
    x = [torch.full(A.shape[:-2], 1.0 + 0.01 * i, dtype=A.dtype,
                    device=A.device) for i in range(n)]
    for _ in range(iters):
        x = _chol_solve_unrolled(L, x, n)
        nrm = torch.sqrt(sum(xi * xi for xi in x) + _EPS)
        x = [xi / nrm for xi in x]
    return torch.stack(x, dim=-1)
