"""Essential-matrix building blocks, batched over leading axes (port of
rpe_tpu/geometry/epipolar.py).

Points are normalized camera coordinates (K^-1 applied) unless noted.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops import kernels
from ._products import matmul, matmuls
from .eig import _cross

_EPS = 1e-12


def normalize_points(pts, K):
    """Pixel coords (..., N, 2) -> normalized camera coords via K^-1."""
    fx, fy, cx, cy = K[..., 0, 0], K[..., 1, 1], K[..., 0, 2], K[..., 1, 2]
    x = (pts[..., 0] - cx[..., None]) / fx[..., None]
    y = (pts[..., 1] - cy[..., None]) / fy[..., None]
    return torch.stack([x, y], dim=-1)


def _build_epipolar_rows(pts1, pts2):
    """Rows a_i with a_i . vec(E) = 0 for x2^T E x1 = 0: (..., N, 9)."""
    x1, y1 = pts1[..., 0], pts1[..., 1]
    x2, y2 = pts2[..., 0], pts2[..., 1]
    one = torch.ones_like(x1)
    return torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], dim=-1)


def normal_matrix(A):
    """A^T A of rows A (..., N, 9) -> (..., 9, 9): the normal matrix of the
    8-point and DLT least-squares fits (P2 on the card)."""
    return matmul(A.transpose(-1, -2), A)


def eight_point(pts1, pts2, weights=None):
    """Weighted 8-point (n-point least-squares) essential matrix: the
    smallest eigenvector of A^T W A. Returns E (..., 3, 3), ||E||_F = 1,
    not yet projected to the essential manifold."""
    from .eig import smallest_eigvec_sym

    A = _build_epipolar_rows(pts1, pts2)
    if weights is not None:
        A = A * weights[..., None]
    e = smallest_eigvec_sym(normal_matrix(A))
    return e.reshape(*e.shape[:-1], 3, 3)


def _det3(M):
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def essential_frame(E):
    """The rotations (U, Vt) of E's projection onto the essential manifold
    (`project_to_essential`), proper rotations, without forming the
    projection. The products are P2's on the card: E^T E, then E v0 and
    E v1 in one launch; the eigendecomposition is P6 and the rest P7."""
    from .eig import eigh3x3_desc

    EtE = matmul(E.transpose(-1, -2), E)
    evals, V = eigh3x3_desc(EtE)
    Ev0, Ev1 = matmuls((E, V[..., :, 0:1]), (E, V[..., :, 1:2]))
    return frame_rotations(evals, V, Ev0, Ev1)


def frame_rotations(evals, V, Ev0, Ev1):
    """`essential_frame`'s own operations after its products: U from E v0
    and E v1 (..., 3, 1) over the singular values sqrt(evals (..., 3)),
    orthonormalized, and V (..., 3, 3), each with its last column flipped
    where its determinant is negative. Returns (U, Vt). CUDA tensors launch
    P7 (csrc/small_solvers.cu), a thread per matrix; CPU tensors take
    `frame_rotations_plain`."""
    if evals.device.type == "cpu":
        return frame_rotations_plain(evals, V, Ev0, Ev1)
    if any(t.dtype != torch.float32 for t in (evals, V, Ev0, Ev1)) \
            or V.shape[-2:] != (3, 3) or evals.shape != V.shape[:-1] \
            or Ev0.shape != V.shape[:-1] + (1,) or Ev1.shape != Ev0.shape:
        raise ValueError("frame_rotations: want float32 evals (..., 3), V "
                         "(..., 3, 3), Ev0 and Ev1 (..., 3, 1)")
    kernels.require_cuda("essential_frame", evals=evals, V=V, Ev0=Ev0,
                         Ev1=Ev1)
    U = torch.empty_like(V)
    Vf = torch.empty_like(V)
    problems = evals.numel() // 3
    if problems:
        kernels.launch("essential_frame", _frame_launcher(kernels.lib(
            "small_solvers")), V, evals.data_ptr(), V.data_ptr(),
            Ev0.data_ptr(), Ev1.data_ptr(), U.data_ptr(), Vf.data_ptr(),
            problems)
    # Vt a transposed view, as the plain version returns it
    return U, Vf.transpose(-1, -2)


@functools.lru_cache(maxsize=None)
def _frame_launcher(lib):
    """P7's launcher with its argument types set, once per loaded
    library."""
    fn = lib.essential_frame_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def frame_rotations_plain(evals, V, Ev0, Ev1):
    """Plain version of P7: `frame_rotations` in eager PyTorch."""
    s = torch.sqrt(torch.clamp_min(evals, 0.0))
    u0 = Ev0[..., 0] / (s[..., 0:1] + _EPS)
    u1 = Ev1[..., 0] / (s[..., 1:2] + _EPS)
    u0 = u0 / (torch.linalg.vector_norm(u0, dim=-1, keepdim=True) + _EPS)
    u1 = u1 - (u0 * u1).sum(-1, keepdim=True) * u0
    u1 = u1 / (torch.linalg.vector_norm(u1, dim=-1, keepdim=True) + _EPS)
    u2 = _cross(u0, u1)
    U = torch.stack([u0, u1, u2], dim=-1)
    # proper rotations: flip the last column where det < 0
    U = torch.cat([U[..., :2],
                   U[..., 2:] * torch.sign(_det3(U))[..., None, None]], dim=-1)
    V = torch.cat([V[..., :2],
                   V[..., 2:] * torch.sign(_det3(V))[..., None, None]], dim=-1)
    return U, V.transpose(-1, -2)


def project_to_essential(E):
    """Project E onto the essential manifold (singular values 1, 1, 0)
    through the closed-form eigendecomposition of E^T E. Returns
    (E_proj, U, Vt), U and Vt proper rotations. On the card the products
    are P2's, E_proj = U (D Vt) a chain of one launch."""
    U, Vt = essential_frame(E)
    D = torch.zeros_like(E)
    D[..., 0, 0] = 1.0
    D[..., 1, 1] = 1.0
    (E_proj,) = matmuls((U, D, Vt))
    return E_proj, U, Vt


def sampson_error_sq(E, pts1, pts2):
    """Squared Sampson distance of each correspondence: E (..., 3, 3),
    pts (..., N, 2) -> (..., N)."""
    u1, v1 = pts1[..., 0], pts1[..., 1]
    u2, v2 = pts2[..., 0], pts2[..., 1]

    def e(i, j):
        return E[..., i, j][..., None]

    Ex1_0 = e(0, 0) * u1 + e(0, 1) * v1 + e(0, 2)
    Ex1_1 = e(1, 0) * u1 + e(1, 1) * v1 + e(1, 2)
    Ex1_2 = e(2, 0) * u1 + e(2, 1) * v1 + e(2, 2)
    Etx2_0 = e(0, 0) * u2 + e(1, 0) * v2 + e(2, 0)
    Etx2_1 = e(0, 1) * u2 + e(1, 1) * v2 + e(2, 1)
    x2tEx1 = u2 * Ex1_0 + v2 * Ex1_1 + Ex1_2
    denom = Ex1_0 ** 2 + Ex1_1 ** 2 + Etx2_0 ** 2 + Etx2_1 ** 2
    return (x2tEx1 ** 2) / (denom + _EPS)
