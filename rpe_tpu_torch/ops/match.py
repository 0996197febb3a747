"""Descriptor matching and its kernels (port of rpe_tpu/ops/match.py and
rpe_tpu/ops/match_pallas.py).

Cross-check matching has the semantics of `cv2.BFMatcher(NORM_HAMMING or
NORM_L2, crossCheck=True)` + sort + truncate; the Lowe ratio test keeps
i -> nn(i) when the best distance is below `ratio` times the second best.
Shapes are static: padded slots are masked with the _BIG sentinel, ties
resolve to the lowest index, and the output is a fixed (max_matches,) set
of indices plus a validity mask. Every function takes a leading pair axis.

Kernels, each with its plain PyTorch version beside it (the wrapper takes
the plain version only for CPU tensors; on a CUDA tensor it launches the
kernel or raises):
  K3 `mutual_nn_hamming`   csrc/match_hamming.cu  Hamming mutual NN
  K7 `mutual_nn_l2`        csrc/match_l2.cu       squared-L2 mutual NN
  K6 `row_top2`            csrc/match_hamming.cu (norm="hamming") and
                           csrc/match_l2.cu (norm="l2"): per-row best
                           distance, its index and the second best
K3 and K6-Hamming run on the int8 tensor cores and are exact. K7 and K6-L2
run their Gram products on the TF32 tensor cores from a hi + lo split of
each value (three products, float32 accumulation), so they agree with their
plain versions up to the rounding of a.b: `argmin_mismatches` and
`near_tie_ok` state that contract.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import kernels

_BIG = 3.0e38


def unpack_descriptor_bits(packed):
    """(..., N, 32) uint8 packed descriptors -> (..., N, 256) {0, 1} uint8,
    bit b of byte j at column 8 j + b (little-endian, numpy's
    `unpackbits(..., bitorder="little")`), so packed OpenCV ORB descriptors
    go through the same matchers; on the input's device."""
    packed = torch.as_tensor(packed, dtype=torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)


def hamming_distance_matrix(bits1, bits2):
    """Pairwise Hamming distances of {0,1} descriptors: (..., N1, B) x
    (..., N2, B) -> (..., N1, N2) float32, as |a| + |b| - 2 a.b (exact:
    integer sums below 2^24)."""
    a = bits1.to(torch.float32)
    b = bits2.to(torch.float32)
    dot = torch.matmul(a, b.transpose(-1, -2))
    na = a.sum(dim=-1)
    nb = b.sum(dim=-1)
    return na[..., :, None] + nb[..., None, :] - 2.0 * dot


def l2sq_distance_matrix(d1, d2):
    """Pairwise squared L2 distances of float descriptors: (..., N1, D) x
    (..., N2, D) -> (..., N1, N2) float32, |a|^2 + |b|^2 - 2 a.b clamped
    at 0."""
    a = d1.to(torch.float32)
    b = d2.to(torch.float32)
    dot = torch.matmul(a, b.transpose(-1, -2))
    na = (a * a).sum(dim=-1)
    nb = (b * b).sum(dim=-1)
    return torch.clamp_min(na[..., :, None] + nb[..., None, :] - 2.0 * dot,
                           0.0)


def _pad_to(x, n: int, fill):
    """Right-pad the last axis of x to length n with `fill` (or cut)."""
    if x.shape[-1] >= n:
        return x[..., :n]
    pad = torch.full((*x.shape[:-1], n - x.shape[-1]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=-1)


def _masked(D, valid1, valid2):
    big = torch.full((), _BIG, dtype=D.dtype, device=D.device)
    D = torch.where(valid1[..., :, None], D, big)
    return torch.where(valid2[..., None, :], D, big)


def mutual_nn_from_matrix(D, valid1, valid2):
    """(best_d, nn12, nn21) of a distance matrix under the validity masks:
    row minimum, row argmin and column argmin, lowest index on ties;
    invalid rows/columns see only _BIG and so resolve to index 0."""
    D = _masked(D, valid1, valid2)
    nn12 = torch.argmin(D, dim=-1)
    nn21 = torch.argmin(D, dim=-2)
    best_d = torch.gather(D, -1, nn12[..., None])[..., 0]
    return best_d, nn12, nn21


def _select(keep, best_d, nn12, max_matches: int):
    """Ascending-distance selection of the kept rows, max_matches of them
    (`approx_max_k` of -distance off the TPU: exact, lowest index first)."""
    big = torch.full((), _BIG, dtype=best_d.dtype, device=best_d.device)
    cand_d = torch.where(keep, best_d, big)
    k = min(max_matches, cand_d.shape[-1])
    _, sel = torch.sort(-cand_d, dim=-1, descending=True, stable=True)
    sel = sel[..., :k]
    idx1 = _pad_to(sel, max_matches, 0)
    idx2 = _pad_to(torch.gather(nn12, -1, sel), max_matches, 0)
    dist = _pad_to(torch.gather(cand_d, -1, sel), max_matches, _BIG)
    return {"idx1": idx1, "idx2": idx2, "dist": dist, "valid": dist < _BIG}


def select_mutual(best_d, nn12, nn21, valid1, max_matches: int):
    """Mutual-NN test + ascending-distance selection of max_matches."""
    i_idx = torch.arange(best_d.shape[-1], device=best_d.device)
    mutual = (torch.gather(nn21, -1, nn12) == i_idx) & valid1 & (best_d < _BIG)
    return _select(mutual, best_d, nn12, max_matches)


def select_ratio(d1, a1, d2, valid1, ratio: float, max_matches: int):
    """Lowe ratio test on per-row (best, argbest, second best) + the
    ascending-distance selection."""
    keep = (d1 < ratio * d2) & valid1 & (d1 < _BIG)
    return _select(keep, d1, a1, max_matches)


def cross_check_match(D, valid1, valid2, max_matches: int = 512):
    """Mutual-nearest-neighbour matching + sort + truncation of a distance
    matrix (..., N1, N2). Returns dict(idx1, idx2, dist, valid), each
    (..., max_matches)."""
    best_d, nn12, nn21 = mutual_nn_from_matrix(D, valid1, valid2)
    return select_mutual(best_d, nn12, nn21, valid1, max_matches)


def row_top2_from_matrix(D, valid1, valid2):
    """(best_d, best_idx, second_d) per row of a distance matrix under the
    validity masks: the second best is the minimum over every other column,
    so it equals the best when the best is tied at another index. Invalid
    rows see only _BIG: (_BIG, 0, _BIG)."""
    D = _masked(D, valid1, valid2)
    best_idx = torch.argmin(D, dim=-1)
    d_best = torch.gather(D, -1, best_idx[..., None])[..., 0]
    cols = torch.arange(D.shape[-1], device=D.device)
    big = torch.full((), _BIG, dtype=D.dtype, device=D.device)
    D2 = torch.where(cols == best_idx[..., None], big, D)
    return d_best, best_idx, D2.min(dim=-1).values


def ratio_test_match(D, valid1, valid2, ratio: float = 0.75,
                     max_matches: int = 512):
    """Lowe-ratio matching of a distance matrix (..., N1, N2): keeps
    i -> nn(i) when d1 < ratio * d2. Same output contract as
    `cross_check_match`."""
    d1, a1, d2 = row_top2_from_matrix(D, valid1, valid2)
    return select_ratio(d1, a1, d2, valid1, ratio, max_matches)


def mutual_nn_hamming_plain(bits1, bits2, valid1, valid2):
    """Plain version of K3: the distance matrix and its masked argmins."""
    best_d, nn12, nn21 = mutual_nn_from_matrix(
        hamming_distance_matrix(bits1, bits2), valid1, valid2)
    return best_d, nn12.to(torch.int32), nn21.to(torch.int32)


def _check_inputs(name, desc1, desc2, valid1, valid2, dtype, dim):
    """Wrapper preconditions of the matching kernels: (P, N, dim) `dtype`
    descriptors, (P, N) bool masks, one CUDA device, contiguous, 16-byte
    aligned (the kernels load descriptors as uint4/float4)."""
    p, n1 = desc1.shape[:2]
    n2 = desc2.shape[1]
    if (desc1.shape != (p, n1, dim) or desc2.shape != (p, n2, dim)
            or desc1.dtype != dtype or desc2.dtype != dtype
            or valid1.shape != (p, n1) or valid2.shape != (p, n2)
            or valid1.dtype != torch.bool or valid2.dtype != torch.bool):
        raise ValueError(f"{name}: want descriptors (P, N, {dim}) {dtype} "
                         f"and valid (P, N) bool")
    kernels.require_cuda(name, desc1=desc1, desc2=desc2, valid1=valid1,
                         valid2=valid2)
    if desc1.data_ptr() % 16 or desc2.data_ptr() % 16:
        raise ValueError(f"{name}: descriptors must be 16-byte aligned")
    return p, n1, n2


@functools.lru_cache(maxsize=None)
def _launcher(lib_name: str, fn_name: str, n_ptrs: int):
    fn = getattr(kernels.lib(lib_name), fn_name)
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# csrc/match_hamming.cu keeps an index in 21 bits of its 32-bit keys
HAMMING_MAX_N = 1 << 21


def check_hamming_n(name, n1, n2):
    """K3/K6-Hamming's precondition: each side's indices fit the kernels'
    21 key bits (N1, N2 < 2^21); raises ValueError otherwise."""
    if max(n1, n2) >= HAMMING_MAX_N:
        raise ValueError(f"{name}: at most {HAMMING_MAX_N - 1} descriptors "
                         f"per side, got N1={n1}, N2={n2}")


def mutual_nn_hamming(bits1, bits2, valid1, valid2):
    """K3: mutual-NN pieces for {0,1} bit descriptors, batched over pairs.

    bits1 (P, N1, 256), bits2 (P, N2, 256) uint8; valid (P, N1), (P, N2)
    bool; N1, N2 < 2^21. Returns best_d (P, N1) float32 (true Hamming
    distance to the nearest valid column, _BIG when none), nn12 (P, N1)
    int32, nn21 (P, N2) int32 -- bit-identical to the argmins of the masked
    distance matrix. Replaces rpe_tpu/ops/match_pallas.py
    `mutual_nn_hamming`. CUDA tensors launch csrc/match_hamming.cu; CPU
    tensors take the plain version.
    """
    if bits1.device.type == "cpu":
        return mutual_nn_hamming_plain(bits1, bits2, valid1, valid2)
    p, n1, n2 = _check_inputs("mutual_nn_hamming", bits1, bits2, valid1,
                              valid2, torch.uint8, 256)
    check_hamming_n("mutual_nn_hamming", n1, n2)
    dev = bits1.device
    best_d = torch.empty((p, n1), dtype=torch.float32, device=dev)
    nn12 = torch.empty((p, n1), dtype=torch.int32, device=dev)
    nn21 = torch.empty((p, n2), dtype=torch.int32, device=dev)
    colkey = torch.empty((p, n2), dtype=torch.int32, device=dev)
    kernels.launch("match_hamming",
                   _launcher("match_hamming", "match_hamming_launch", 8),
                   bits1, *(kernels.ptr(t) for t in (
                       bits1, bits2, valid1, valid2, best_d, nn12, nn21,
                       colkey)), p, n1, n2)
    return best_d, nn12, nn21


# csrc/match_l2.cu indexes slots and descriptors of all pairs with 32-bit
# ints and puts the pair on the grid's y axis
L2_MAX_PAIRS = 65535
L2_MAX_SLOTS = (1 << 31) - 1


def check_l2_shape(name, p, n1, n2):
    """K7/K6-L2's precondition: P <= 65535 pairs and P * N < 2^31 slots on
    each side; raises ValueError otherwise."""
    if p > L2_MAX_PAIRS or p * max(n1, n2) > L2_MAX_SLOTS:
        raise ValueError(f"{name}: at most {L2_MAX_PAIRS} pairs and "
                         f"{L2_MAX_SLOTS} descriptors per side over all "
                         f"pairs, got P={p}, N1={n1}, N2={n2}")


@functools.lru_cache(maxsize=64)
def _l2_scratch_bytes(p: int, n1: int, n2: int) -> int:
    """Bytes of csrc/match_l2.cu's scratch for one call (its hi/lo split,
    norms, tile flags and column keys)."""
    fn = kernels.lib("match_l2").match_l2_scratch_bytes
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_size_t
    return int(fn(p, n1, n2))


def _l2_launch(name, fn_name, desc1, desc2, valid1, valid2, out_spec):
    """Check the inputs, allocate the outputs ((dtype, side) each: a (P, N1)
    or (P, N2) tensor) and the scratch, launch one of csrc/match_l2.cu's
    entry points and count it."""
    p, n1, n2 = _check_inputs(name, desc1, desc2, valid1, valid2,
                              torch.float32, 128)
    check_l2_shape(name, p, n1, n2)
    dev = desc1.device
    outs = tuple(torch.empty((p, n1 if side == 1 else n2), dtype=dtype,
                             device=dev) for dtype, side in out_spec)
    scratch = torch.empty(_l2_scratch_bytes(p, n1, n2), dtype=torch.uint8,
                          device=dev)
    kernels.launch(name, _launcher("match_l2", fn_name, 8), desc1,
                   *(kernels.ptr(t) for t in (desc1, desc2, valid1, valid2,
                                              *outs, scratch)), p, n1, n2)
    return outs


def mutual_nn_l2_plain(desc1, desc2, valid1, valid2):
    """Plain version of K7: the clamped squared-L2 matrix and its masked
    argmins (the reference's formulation off the TPU)."""
    best_d, nn12, nn21 = mutual_nn_from_matrix(
        l2sq_distance_matrix(desc1, desc2), valid1, valid2)
    return best_d, nn12.to(torch.int32), nn21.to(torch.int32)


def mutual_nn_l2(desc1, desc2, valid1, valid2):
    """K7: mutual-NN pieces for float descriptors (squared L2), batched
    over pairs.

    desc1 (P, N1, 128), desc2 (P, N2, 128) float32; valid (P, N1),
    (P, N2) bool. Returns best_d (P, N1) float32 (distance to the nearest
    valid column, clamped at 0; _BIG when none), nn12 (P, N1) int32, nn21
    (P, N2) int32: the argmins of the clamped, masked distance matrix up to
    the rounding of the dot products (a near-tie may resolve to the other
    candidate). P <= 65535 and P * N < 2^31 per side. Replaces
    rpe_tpu/ops/match_pallas.py `mutual_nn_l2sq`. CUDA tensors launch
    csrc/match_l2.cu; CPU tensors take the plain version.
    """
    if desc1.device.type == "cpu":
        return mutual_nn_l2_plain(desc1, desc2, valid1, valid2)
    return _l2_launch("match_l2", "match_l2_launch", desc1, desc2, valid1,
                      valid2, ((torch.float32, 1), (torch.int32, 1),
                               (torch.int32, 2)))


def row_top2_plain(desc1, desc2, valid1, valid2, norm: str = "hamming"):
    """Plain version of K6: the distance matrix (Hamming, or squared L2
    clamped at 0) and its per-row best, argbest and second best."""
    if norm not in ("hamming", "l2"):
        raise ValueError(f"Unknown norm type: {norm}")
    dist = hamming_distance_matrix if norm == "hamming" else \
        l2sq_distance_matrix
    d1, a1, d2 = row_top2_from_matrix(dist(desc1, desc2), valid1, valid2)
    return d1, a1.to(torch.int32), d2


def row_top2(desc1, desc2, valid1, valid2, norm: str = "hamming"):
    """K6: per-row (best distance, its lowest index, second best) for the
    Lowe ratio test, batched over pairs.

    norm="hamming": desc (P, N, 256) uint8 {0,1} bits, N < 2^21, exact
    distances.
    norm="l2": desc (P, N, 128) float32, squared L2 clamped at 0, equal to
    the plain version up to the rounding of a.b; P <= 65535, P * N < 2^31
    per side.
    The second best is the minimum over every other valid column (equal to
    the best when the best is tied at another index); an invalid row gives
    (_BIG, 0, _BIG).
    Returns d1 (P, N1) float32, a1 (P, N1) int32, d2 (P, N1) float32.
    Replaces rpe_tpu/ops/match_pallas.py `_row_top2`. CUDA tensors launch
    csrc/match_hamming.cu or csrc/match_l2.cu; CPU tensors take the plain
    version.
    """
    if desc1.device.type == "cpu":
        return row_top2_plain(desc1, desc2, valid1, valid2, norm)
    if norm == "l2":
        return _l2_launch("row_top2_l2", "row_top2_l2_launch", desc1, desc2,
                          valid1, valid2, ((torch.float32, 1),
                                           (torch.int32, 1),
                                           (torch.float32, 1)))
    if norm != "hamming":
        raise ValueError(f"Unknown norm type: {norm}")
    name = "row_top2_hamming"
    p, n1, n2 = _check_inputs(name, desc1, desc2, valid1, valid2,
                              torch.uint8, 256)
    check_hamming_n(name, n1, n2)
    dev = desc1.device
    outs = (torch.empty((p, n1), dtype=torch.float32, device=dev),
            torch.empty((p, n1), dtype=torch.int32, device=dev),
            torch.empty((p, n1), dtype=torch.float32, device=dev))
    kernels.launch(name, _launcher("match_hamming", f"{name}_launch", 7),
                   desc1, *(kernels.ptr(t) for t in (desc1, desc2, valid1,
                                                     valid2, *outs)),
                   p, n1, n2)
    return outs


NEAR_TIE_TOL = 1e-5    # distance gap within which two candidates are a tie
NEAR_TIE_FRAC = 1e-3   # share of rows (or columns) whose index may differ


def argmin_mismatches(D, got, want, valid, dim: int = -1):
    """Two argmin index tensors of the masked distance matrix D (P, N1, N2)
    along dim (-1: one index per row, -2: one per column), compared where
    `valid`. Returns (mismatches, compared, largest gap between the D
    entries of a mismatch's two candidates)."""
    got, want = got.long(), want.long()
    mism = (got != want) & valid
    if dim == -1:
        dg = torch.gather(D, -1, got[..., None])[..., 0]
        dw = torch.gather(D, -1, want[..., None])[..., 0]
    else:
        dg = torch.gather(D, -2, got[..., None, :])[..., 0, :]
        dw = torch.gather(D, -2, want[..., None, :])[..., 0, :]
    gap = float((dg - dw).abs()[mism].max()) if bool(mism.any()) else 0.0
    return int(mism.sum()), int(valid.sum()), gap


def near_tie_ok(m, frac: float = NEAR_TIE_FRAC, tol: float = NEAR_TIE_TOL):
    """The float kernels' index contract against their plain versions, on
    `argmin_mismatches` output: at most `frac` of the compared rows or
    columns differ, and each difference is a near-tie within `tol`."""
    n_bad, n, gap = m
    return n_bad <= frac * n and gap <= tol


def match_hamming(bits1, bits2, valid1, valid2, max_matches: int = 500):
    """Cross-check Hamming matching, batched over pairs: K3 + selection."""
    best_d, nn12, nn21 = mutual_nn_hamming(bits1, bits2, valid1, valid2)
    return select_mutual(best_d, nn12.long(), nn21.long(), valid1,
                         max_matches)


def match_l2(desc1, desc2, valid1, valid2, max_matches: int = 500):
    """Cross-check squared-L2 matching, batched over pairs: K7 + selection."""
    best_d, nn12, nn21 = mutual_nn_l2(desc1, desc2, valid1, valid2)
    return select_mutual(best_d, nn12.long(), nn21.long(), valid1,
                         max_matches)


def match_ratio(desc1, desc2, valid1, valid2, ratio: float = 0.75,
                max_matches: int = 500, norm: str = "hamming"):
    """Lowe-ratio matching, batched over pairs: K6 + selection. For
    norm="l2" the distances are squared, so callers pass ratio**2."""
    d1, a1, d2 = row_top2(desc1, desc2, valid1, valid2, norm)
    return select_ratio(d1, a1.long(), d2, valid1, ratio, max_matches)
