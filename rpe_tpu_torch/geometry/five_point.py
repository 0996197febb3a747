"""Batched 5-point essential-matrix minimal solver, the root kernels K4
and K5 (port of rpe_tpu/geometry/five_point.py and the functions of
rpe_tpu/ops/five_point_pallas.py `solve_roots_polished` and
`find_root_brackets`) and the port's coefficient kernel P1.

Hidden-variable resultant (Li & Hartley, ICPR 2006):
  1. nullspace of the 5x9 epipolar system by unrolled Householder QR ->
     E(x, y, z) = x X + y Y + z Z + W;
  2. the ten cubic constraints expanded numerically over the 20 monomials
     of degree <= 3 with static multiplication tables (steps 1-2 are P1 on
     the card, one launch in a batch-independent order);
  3. hiding z: M(z) m(x, y) = 0, roots where det M(z) changes sign on a
     97-point tan grid, bisected (K4, or its plain version);
  4. per root: chart choice, null vector, Gauss-Newton polish -> E.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..ops import kernels
from ..utils.observability import htod

_EPS = 1e-20

GRID = 97           # tan-spaced determinant evaluation points
MAX_ROOTS = 10      # degree bound of the hidden-variable determinant
BISECT_ITERS = 10   # coarse root isolation; the polish converges
# A root that K4's polish carries to |z| >= ZKEEP, 1.2 x the grid's last
# |tan| (the bound of the reference kernel's contract,
# tests/test_pallas_kernels.py:184), has left its bracket without
# converging (two close roots or a pole); K4 undoes that polish, where the
# plain version and the reference keep it (ROADMAP Known divergences)
ZKEEP = 1.2e3


def _monomials(max_deg):
    """All (a, b, c) with a+b+c <= max_deg for (x, y, z), fixed order."""
    out = []
    for total in range(max_deg, -1, -1):
        for a in range(total, -1, -1):
            for b in range(total - a, -1, -1):
                out.append((a, b, total - a - b))
    return out


_M1 = _monomials(1)      # 4:  [x, y, z, 1]
_M2 = _monomials(2)      # 10
_M3 = _monomials(3)      # 20
_M2_IDX = {m: i for i, m in enumerate(_M2)}
_M3_IDX = {m: i for i, m in enumerate(_M3)}

_XY_GROUPS = [(3, 0), (2, 1), (1, 2), (0, 3), (2, 0), (1, 1), (0, 2),
              (1, 0), (0, 1), (0, 0)]
_XY_IDX = {g: i for i, g in enumerate(_XY_GROUPS)}


@functools.lru_cache(maxsize=None)
def _mul_tables():
    """T1 (4,4,10): deg1*deg1 -> deg2; T2 (10,4,20): deg2*deg1 -> deg3."""
    T1 = np.zeros((4, 4, 10), dtype=np.float32)
    for i, (a1, b1, c1) in enumerate(_M1):
        for j, (a2, b2, c2) in enumerate(_M1):
            T1[i, j, _M2_IDX[(a1 + a2, b1 + b2, c1 + c2)]] = 1.0
    T2 = np.zeros((10, 4, 20), dtype=np.float32)
    for i, (a1, b1, c1) in enumerate(_M2):
        for j, (a2, b2, c2) in enumerate(_M1):
            T2[i, j, _M3_IDX[(a1 + a2, b1 + b2, c1 + c2)]] = 1.0
    return T1, T2


@functools.lru_cache(maxsize=None)
def _deriv_tables():
    """D (3, 20, 20): d(mono_m)/d(var v) = D[v, m, m'] * mono_m'."""
    D = np.zeros((3, 20, 20), dtype=np.float32)
    for m, (a, b, c) in enumerate(_M3):
        if a > 0:
            D[0, m, _M3_IDX[(a - 1, b, c)]] = a
        if b > 0:
            D[1, m, _M3_IDX[(a, b - 1, c)]] = b
        if c > 0:
            D[2, m, _M3_IDX[(a, b, c - 1)]] = c
    return D


@functools.lru_cache(maxsize=None)
def _hidden_var_table():
    """S (20, 10, 4): deg3-monomial -> (xy-group, z-power) scatter."""
    S = np.zeros((20, 10, 4), dtype=np.float32)
    for m, (a, b, c) in enumerate(_M3):
        S[m, _XY_IDX[(a, b)], c] = 1.0
    return S


@functools.lru_cache(maxsize=None)
def _flip_table():
    """P (20, 20): coefficient permutation for the projective chart
    (x, y, z) = (u/w, v/w, 1/w): monomial x^a y^b z^c -> u^a v^b w^(3-a-b-c)."""
    P = np.zeros((20, 20), dtype=np.float32)
    for m, (a, b, c) in enumerate(_M3):
        P[m, _M3_IDX[(a, b, 3 - a - b - c)]] = 1.0
    return P


@functools.lru_cache(maxsize=None)
def _tan_grid():
    """The 97 grid angles, float32, from -pi/2 + 1e-3 to pi/2 - 1e-3 (the
    reference's jnp.linspace agrees to 2 ulp)."""
    return np.linspace(-0.5 * np.pi + 1e-3, 0.5 * np.pi - 1e-3,
                       GRID).astype(np.float32)


def _kernel_tables():
    """The static index tables csrc/five_point_roots.cu hard-codes:
    group_mono (10, 4) monomial of (xy-group, z-power) or -1, flip (20)
    the projective-chart monomial map, exps (20, 3)."""
    gm = np.full((10, 4), -1, np.int32)
    for m, (a, b, c) in enumerate(_M3):
        gm[_XY_IDX[(a, b)], c] = m
    flip = np.array([_M3_IDX[(a, b, 3 - a - b - c)] for (a, b, c) in _M3],
                    np.int32)
    return gm, flip, np.array(_M3, np.int32)


def _t(a, like):
    """A static float table as a tensor of `like`'s device and dtype."""
    return torch.from_numpy(a).to(like.device, like.dtype)


# ---------------------------------------------------------------------------
# Unrolled small linear algebra
# ---------------------------------------------------------------------------

def _householder_null4(A):
    """Orthonormal 4-dim nullspace of A (..., 5, 9) via Householder QR of
    A^T. Returns (..., 9, 4)."""
    R = A.transpose(-1, -2).clone()                 # (..., 9, 5)
    batch = R.shape[:-2]
    Q = torch.eye(9, dtype=A.dtype, device=A.device).expand(
        *batch, 9, 9).clone()
    for k_ in range(5):
        x = R[..., k_:, k_]
        normx = torch.sqrt((x * x).sum(-1) + _EPS)
        sign = torch.where(x[..., 0] >= 0, 1.0, -1.0)
        v = x.clone()
        v[..., 0] = v[..., 0] + sign * normx
        vnorm2 = (v * v).sum(-1, keepdim=True) + _EPS
        vR = torch.matmul(v[..., None, :], R[..., k_:, k_:])[..., 0, :]
        R[..., k_:, k_:] = R[..., k_:, k_:] + (
            -2.0 * v[..., :, None] * vR[..., None, :] / vnorm2[..., None])
        Qv = torch.matmul(Q[..., :, k_:], v[..., :, None])[..., 0]
        Q[..., :, k_:] = Q[..., :, k_:] + (
            -2.0 * Qv[..., :, None] * v[..., None, :] / vnorm2[..., None])
    return Q[..., :, 5:]


def _det10_lu(M):
    """Determinant of (..., 10, 10) by unrolled LU without pivoting."""
    n = 10
    det = torch.ones(M.shape[:-2], dtype=M.dtype, device=M.device)
    A = M.clone()
    for k_ in range(n - 1):
        piv = A[..., k_, k_]
        det = det * piv
        safe = torch.where(piv.abs() > _EPS, piv, 1.0)
        factor = A[..., k_ + 1:, k_] / safe[..., None]
        A[..., k_ + 1:, k_:] = A[..., k_ + 1:, k_:] + (
            -(factor[..., :, None] * A[..., k_, k_:][..., None, :]))
    return det * A[..., n - 1, n - 1]


# ---------------------------------------------------------------------------
# Polynomial system construction
# ---------------------------------------------------------------------------

def _build_constraint_coeffs(null4):
    """null4 (..., 9, 4) -> coefficient matrix (..., 10, 20): rows det E and
    the 9 entries of 2 E E^T E - tr(E E^T) E over the monomials _M3."""
    T1, T2 = (_t(t, null4) for t in _mul_tables())
    Ep = null4.reshape(*null4.shape[:-2], 3, 3, 4)

    def mul11(p, q):
        return torch.einsum("...a,...b,abm->...m", p, q, T1)

    def mul21(p, q):
        return torch.einsum("...a,...b,abm->...m", p, q, T2)

    def minor(r0, r1, c0, c1):
        return (mul11(Ep[..., r0, c0, :], Ep[..., r1, c1, :])
                - mul11(Ep[..., r0, c1, :], Ep[..., r1, c0, :]))

    detE = (mul21(minor(1, 2, 1, 2), Ep[..., 0, 0, :])
            - mul21(minor(1, 2, 0, 2), Ep[..., 0, 1, :])
            + mul21(minor(1, 2, 0, 1), Ep[..., 0, 2, :]))

    EEt = [[sum(mul11(Ep[..., i, k_, :], Ep[..., j, k_, :]) for k_ in range(3))
            for j in range(3)] for i in range(3)]
    trace = EEt[0][0] + EEt[1][1] + EEt[2][2]

    rows = [detE]
    for i in range(3):
        for j in range(3):
            acc = sum(mul21(EEt[i][k_], Ep[..., k_, j, :])
                      for k_ in range(3)) * 2.0
            acc = acc - mul21(trace, Ep[..., i, j, :])
            rows.append(acc)
    return torch.stack(rows, dim=-2)


def _eval_Mz(coeffs, z):
    """Hidden-variable matrix M(z): coeffs (..., 10, 20), z (...,) ->
    (..., 10, 10)."""
    S = _t(_hidden_var_table(), coeffs)
    zp = torch.stack([torch.ones_like(z), z, z * z, z * z * z], dim=-1)
    return torch.einsum("...em,mgc,...c->...eg", coeffs, S, zp)


def _detM_at(coeffs, z):
    return _det10_lu(_eval_Mz(coeffs, z))


def _monos3(x, y, z):
    return torch.stack([(x ** a) * (y ** b) * (z ** c) for (a, b, c) in _M3],
                       dim=-1)


def _gn_refine(coeffs, x, y, z, iters: int = 4):
    """Gauss-Newton on the 10 cubic constraints over (x, y, z)."""
    D = _t(_deriv_tables(), coeffs)
    eye = torch.eye(3, dtype=coeffs.dtype, device=coeffs.device)
    for _ in range(iters):
        m = _monos3(x, y, z)
        r = torch.einsum("...em,...m->...e", coeffs, m)
        dm = torch.einsum("vmn,...n->...vm", D, m)
        J = torch.einsum("...em,...vm->...ev", coeffs, dm)
        JtJ = torch.einsum("...ev,...ew->...vw", J, J) + 1e-12 * eye
        Jtr = torch.einsum("...ev,...e->...v", J, r)
        a, b_, c = JtJ[..., 0, 0], JtJ[..., 0, 1], JtJ[..., 0, 2]
        e, f = JtJ[..., 1, 1], JtJ[..., 1, 2]
        i_ = JtJ[..., 2, 2]
        det = (a * (e * i_ - f * f) - b_ * (b_ * i_ - f * c)
               + c * (b_ * f - e * c))
        det = torch.where(det.abs() > _EPS, det, 1.0)
        gx, gy, gz = Jtr[..., 0], Jtr[..., 1], Jtr[..., 2]
        dx = -((e * i_ - f * f) * gx + (c * f - b_ * i_) * gy
               + (b_ * f - c * e) * gz) / det
        dy = -((c * f - b_ * i_) * gx + (a * i_ - c * c) * gy
               + (c * b_ - a * f) * gz) / det
        dz = -((b_ * f - c * e) * gx + (c * b_ - a * f) * gy
               + (a * e - b_ * b_) * gz) / det
        x, y, z = x + dx, y + dy, z + dz
    return x, y, z


# ---------------------------------------------------------------------------
# K4: root isolation + chart-aware extraction + polish
# ---------------------------------------------------------------------------

def find_root_brackets_plain(coeffs):
    """Plain version of K5 (the bracket half of the reference's XLA branch,
    rpe_tpu/geometry/five_point.py:345-370): det M(z) on the 97-point tan
    grid, its first MAX_ROOTS sign changes in grid order, 10 bisection
    steps each. coeffs (B, 10, 20) -> (t_lo, t_hi, has_root), each (B,
    MAX_ROOTS), z = tan(t); slots without a root are 0, 0, False."""
    from ..ops.orb import top_k_stable

    batch = coeffs.shape[:-2]
    t = _t(_tan_grid(), coeffs)
    zgrid = torch.tan(t)
    d = _detM_at(coeffs[..., None, :, :], zgrid.expand(*batch, GRID))

    sign = torch.sign(d)
    change = (sign[..., :-1] * sign[..., 1:]) < 0
    score = torch.where(
        change, -torch.arange(GRID - 1, dtype=torch.float32,
                              device=coeffs.device), -torch.inf)
    _, bidx = top_k_stable(score, MAX_ROOTS)
    has_root = torch.gather(change, -1, bidx)
    t_lo = t[bidx]
    t_hi = t[bidx + 1]
    d_lo = torch.gather(d, -1, bidx)

    for _ in range(BISECT_ITERS):
        mid = 0.5 * (t_lo + t_hi)
        dm = _detM_at(coeffs[..., None, :, :], torch.tan(mid))
        same = (torch.sign(dm) * torch.sign(d_lo)) >= 0
        t_lo, d_lo, t_hi = (torch.where(same, mid, t_lo),
                            torch.where(same, dm, d_lo),
                            torch.where(same, t_hi, mid))
    return (torch.where(has_root, t_lo, 0.0), torch.where(has_root, t_hi, 0.0),
            has_root)


def find_root_brackets(coeffs):
    """K5: `find_root_brackets_plain`'s function on (B, 10, 20) float32
    coefficients, from K4's bracket kernel alone (det M's sign from the
    pivot signs of its LU, as K4). CUDA tensors launch
    csrc/five_point_roots.cu; CPU tensors take the plain version."""
    if coeffs.device.type == "cpu":
        return find_root_brackets_plain(coeffs)
    launch = _launchers("find_root_brackets", coeffs)[1]
    b = coeffs.shape[0]
    brackets = torch.empty((b, 3, MAX_ROOTS), dtype=torch.float32,
                           device=coeffs.device)
    kernels.launch("root_brackets", launch, coeffs, kernels.ptr(coeffs),
                   kernels.ptr(_device_tan_grid(coeffs.device)),
                   kernels.ptr(brackets), b)
    t_lo, t_hi, has = brackets.unbind(1)
    return t_lo, t_hi, has > 0.5


def solve_roots_plain(coeffs):
    """Plain version of K4 (the reference's XLA branch,
    rpe_tpu/geometry/five_point.py:345-414).

    coeffs (B, 10, 20) row-normalized. Returns (x, y, r_var, flip,
    has_root), each (B, MAX_ROOTS): the polished solution per real root in
    the chart `flip` selects (E = x X + y Y + r Z + W where False,
    x X + y Y + Z + r W where True). Slots without a root hold unpolished
    values and has_root False.
    """
    from .eig import smallest_eigvec_sym

    t_lo, t_hi, has_root = find_root_brackets_plain(coeffs)
    z_root = torch.tan(0.5 * (t_lo + t_hi))

    P = _t(_flip_table(), coeffs)
    coeffs_flip = torch.einsum("...em,mn->...en", coeffs, P)
    flip = z_root.abs() > 1.0
    safe_z = torch.where(z_root.abs() > 1e-20, z_root, 1.0)
    r_var = torch.where(flip, 1.0 / safe_z, z_root)
    coeffs_r = torch.where(flip[..., None, None], coeffs_flip[..., None, :, :],
                           coeffs[..., None, :, :])

    Mz = _eval_Mz(coeffs_r, r_var)
    MtM = torch.matmul(Mz.transpose(-1, -2), Mz)
    m = smallest_eigvec_sym(MtM, iters=4)
    one, xq, yq = m[..., 9], m[..., 7], m[..., 8]
    use_alt = one.abs() < 1e-8
    x = torch.where(use_alt, m[..., 4] / (xq + _EPS), xq / (one + _EPS))
    y = torch.where(use_alt, m[..., 5] / (xq + _EPS), yq / (one + _EPS))
    x, y, r_var = _gn_refine(coeffs_r, x, y, r_var)
    return x, y, r_var, flip, has_root


def solve_roots_polished(coeffs):
    """K4: roots of det M(z) on the 97-point tan grid (first MAX_ROOTS sign
    changes, 10 bisection steps each), then per root the chart choice, a
    null vector of M by back-substitution on its unpivoted LU, and a
    4-iteration Gauss-Newton polish. Outputs as `solve_roots_plain`, with
    x, y, r_var zero where has_root is False. A root that the polish
    carries to |z| >= ZKEEP keeps its unpolished values (the bracket's
    midpoint and its null vector), where the plain version keeps the
    polished ones.

    CUDA tensors launch csrc/five_point_roots.cu; CPU tensors take the plain
    version.
    """
    if coeffs.device.type == "cpu":
        return solve_roots_plain(coeffs)
    return _solve_roots_polished(coeffs)[:5]


def _solve_roots_polished(coeffs):
    """K4's outputs on CUDA coefficients and the mask (B, MAX_ROOTS) of the
    roots whose polish it undid."""
    launch = _launchers("solve_roots_polished", coeffs)[0]
    b = coeffs.shape[0]
    n = b * MAX_ROOTS
    # one float buffer: the brackets (B, 3, MAX_ROOTS) the polish reads,
    # then x, y, r_var; one bool buffer: flip, has_root, undone
    f32 = torch.empty((6, b, MAX_ROOTS), dtype=torch.float32,
                      device=coeffs.device)
    flags = torch.empty((3, b, MAX_ROOTS), dtype=torch.bool,
                        device=coeffs.device)
    p, q = kernels.ptr(f32), kernels.ptr(flags)
    kernels.launch("five_point_roots", launch, coeffs, kernels.ptr(coeffs),
                   kernels.ptr(_device_tan_grid(coeffs.device)), p,
                   p + 12 * n, p + 16 * n, p + 20 * n, q, q + n, q + 2 * n,
                   b)
    _, _, _, x, y, r_var = f32.unbind(0)
    flip, has, undone = flags.unbind(0)
    return x, y, r_var, flip, has, undone


def _launchers(name, coeffs):
    """K4's and K5's preconditions -- coeffs (B, 10, 20) float32, contiguous
    on a CUDA device -- and their launchers."""
    if coeffs.dim() != 3 or coeffs.shape[1:] != (10, 20) \
            or coeffs.dtype != torch.float32:
        raise ValueError(f"{name}: want (B, 10, 20) float32")
    kernels.require_cuda(name, coeffs=coeffs)
    return _lib_launchers(kernels.lib("five_point_roots"))


@functools.lru_cache(maxsize=None)
def _device_tan_grid(device):
    """The tan grid on the card, copied there once per device (a tensor's
    device, so one with its index)."""
    return htod(_tan_grid(), device)


@functools.lru_cache(maxsize=None)
def _lib_launchers(lib):
    """The library's K4 and K5 launchers with their argument types set,
    once per loaded library, after holding the kernel's hard-coded
    monomial tables to these."""
    gm, flip, exps = _kernel_tables()
    buf = (ctypes.c_int * (40 + 20 + 60))()
    lib.five_point_tables(buf)
    got = np.array(buf[:], dtype=np.int32)
    want = np.concatenate([gm.reshape(-1), flip, exps.reshape(-1)])
    if not np.array_equal(got, want):
        raise RuntimeError("five_point_roots.cu monomial tables disagree with "
                           "geometry/five_point.py")
    roots = lib.five_point_roots_launch
    roots.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p]
    roots.restype = ctypes.c_int
    brackets = lib.five_point_brackets_launch
    brackets.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                 ctypes.c_void_p]
    brackets.restype = ctypes.c_int
    return roots, brackets


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------

def constraint_coeffs_plain(pts1, pts2):
    """Plain version of P1: minimal samples pts (..., 5, 2) -> (null4
    (..., 9, 4), row-normalized constraint coefficients (..., 10, 20)): the
    input of K4."""
    from .epipolar import _build_epipolar_rows

    null4 = _householder_null4(_build_epipolar_rows(pts1, pts2))
    coeffs = _build_constraint_coeffs(null4)
    rn = torch.sqrt((coeffs * coeffs).sum(-1, keepdim=True) + _EPS)
    return null4, coeffs / rn


def constraint_coeffs(pts1, pts2):
    """P1: `constraint_coeffs_plain`'s function of float32 minimal samples
    pts (..., 5, 2), computed per hypothesis in an order that does not
    depend on the batch. CUDA tensors launch csrc/five_point_coeffs.cu;
    CPU tensors take the plain version."""
    if pts1.device.type == "cpu":
        return constraint_coeffs_plain(pts1, pts2)
    if pts1.shape != pts2.shape or pts1.shape[-2:] != (5, 2) \
            or pts1.dtype != torch.float32 or pts2.dtype != torch.float32:
        raise ValueError("constraint_coeffs: want two (..., 5, 2) float32")
    batch = pts1.shape[:-2]
    p1 = pts1.reshape(-1, 5, 2).contiguous()
    p2 = pts2.reshape(-1, 5, 2).contiguous()
    kernels.require_cuda("five_point_coeffs", pts1=p1, pts2=p2)
    null4 = torch.empty((*batch, 9, 4), dtype=torch.float32,
                        device=p1.device)
    coeffs = torch.empty((*batch, 10, 20), dtype=torch.float32,
                         device=p1.device)
    kernels.launch("five_point_coeffs",
                   _coeffs_launcher(kernels.lib("five_point_coeffs")), p1,
                   kernels.ptr(p1), kernels.ptr(p2), kernels.ptr(null4),
                   kernels.ptr(coeffs), p1.shape[0])
    return null4, coeffs


@functools.lru_cache(maxsize=None)
def _coeffs_launcher(lib):
    """P1's launcher with its argument types set, once per loaded library,
    after holding the kernel's hard-coded multiplication tables to
    `_mul_tables()`."""
    buf = (ctypes.c_int * (160 + 800))()
    lib.five_point_coeffs_tables(buf)
    T1, T2 = _mul_tables()
    want = np.concatenate([T1.reshape(-1), T2.reshape(-1)]).astype(np.int32)
    if not np.array_equal(np.array(buf[:], dtype=np.int32), want):
        raise RuntimeError("five_point_coeffs.cu multiplication tables "
                           "disagree with geometry/five_point.py")
    fn = lib.five_point_coeffs_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def five_point_essential(pts1, pts2):
    """Minimal 5-point solver batched over leading dims: pts (..., 5, 2)
    normalized coords -> (E (..., MAX_ROOTS, 3, 3), valid (..., MAX_ROOTS))."""
    null4, coeffs = constraint_coeffs(pts1, pts2)
    batch = coeffs.shape[:-2]

    x, y, r_var, flip, has_root = solve_roots_polished(
        coeffs.reshape(-1, 10, 20).contiguous())
    x, y, r_var, flip, has_root = (a.reshape(*batch, MAX_ROOTS)
                                   for a in (x, y, r_var, flip, has_root))
    return _assemble_candidates(null4, x, y, r_var, flip, has_root)


def _assemble_candidates(null4, x, y, r_var, flip, has_root):
    """(x, y, r_var, flip) per root -> normalized E candidates; non-finite
    candidates are replaced by W and marked invalid."""
    X = null4[..., None, :, 0]
    Y = null4[..., None, :, 1]
    Z = null4[..., None, :, 2]
    W = null4[..., None, :, 3]
    cz = torch.where(flip, 1.0, r_var)
    cw = torch.where(flip, r_var, 1.0)
    e_vec = (x[..., None] * X + y[..., None] * Y
             + cz[..., None] * Z + cw[..., None] * W)
    finite = torch.isfinite(e_vec).all(-1)
    has_root = has_root & finite
    e_vec = torch.where(finite[..., None], e_vec, W.expand_as(e_vec))
    E = e_vec.reshape(*e_vec.shape[:-1], 3, 3)
    nrm = torch.sqrt((e_vec * e_vec).sum(-1) + _EPS)
    return E / nrm[..., None, None], has_root
