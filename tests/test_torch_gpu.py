"""rpe_tpu_torch's CUDA kernels against their plain versions, on the card,
and each path launching its kernels and agreeing with its CPU run.

Every test here needs a CUDA device and skips without one (the decision is
made inside the `cuda` fixture, never at import). This file imports neither
jax nor rpe_tpu, so it also runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_gpu.py
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from rpe_tpu_torch import rng
from rpe_tpu_torch.config import EstimatorConfig, MatcherConfig, OrbConfig, \
    RansacConfig, SiftConfig, profile_config
from rpe_tpu_torch.geometry import five_point as fp
from rpe_tpu_torch.ops import extract as textract
from rpe_tpu_torch.ops import kernels
from rpe_tpu_torch.ops.atlas import band_tables
from rpe_tpu_torch.ops.extract import extract_brief, extract_brief_plain
from rpe_tpu_torch.ops.fast import fast_harris_rank_map, \
    fast_harris_rank_map_plain
from rpe_tpu_torch.ops.match import argmin_mismatches, \
    l2sq_distance_matrix, mutual_nn_hamming, mutual_nn_hamming_plain, \
    mutual_nn_l2, mutual_nn_l2_plain, near_tie_ok, row_top2, row_top2_plain
from rpe_tpu_torch.ops.orb import atlas_keypoints
from rpe_tpu_torch.ops.pyramid import build_pyramid
from rpe_tpu_torch.pipeline.estimator import PoseEstimator, estimate_pair, \
    estimate_pairs_batched, estimate_sequence_batched
from rpe_tpu_torch.utils.synthetic import float_descriptors, make_sequence, \
    rotation_error_deg
from torch_gates import default_extraction_gates  # noqa: F401
from torch_judges import p1_judge, p2_judge, p2_serial, p3_judge, \
    p3_references, p3_serial, p4_judge, plain_small_solvers, same_bits

pytestmark = pytest.mark.gpu

SMALL = EstimatorConfig(orb=OrbConfig(nfeatures=512, nlevels=4, max_kpts=512),
                        matcher=MatcherConfig(max_matches=256),
                        ransac=RansacConfig(num_hypotheses=128))
SIFT_A = dataclasses.replace(
    SMALL, feature_method="SIFT", sift=SiftConfig(max_kpts=1024),
    matcher=MatcherConfig(norm_type="l2", max_matches=256))
SIFT_B = dataclasses.replace(SIFT_A, matcher=dataclasses.replace(
    SIFT_A.matcher, cross_check=False))
ORB_RATIO = dataclasses.replace(SMALL, matcher=dataclasses.replace(
    SMALL.matcher, cross_check=False))
BIG = 3.0e38


SMALL_SOLVERS = set(kernels.SMALL_SOLVERS_PER_CALL["5pt"])     # P5-P8
GEOMETRY = {"five_point_coeffs", "fixed_order_bmm"} | SMALL_SOLVERS
SIFT_KERNELS = {"sift_orientation_hist", "sift_descriptor"}   # P3, P4


def geometry(calls, lo=False):
    """P1's, P2's and P5-P8's launches in `calls` estimator calls."""
    return kernels.geometry_launches(calls, "lo" if lo else "5pt")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    kernels.build_all()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def scene(cuda):
    frames, K, (R, _) = make_sequence(3, 240, 480, seed=2)
    o = SMALL.orb
    kp = atlas_keypoints(torch.from_numpy(frames[:1]).to(cuda), o.nfeatures,
                         o.nlevels, o.scale_factor, o.fast_threshold,
                         o.max_kpts)
    return frames, K, R, kp


def _wrapped_plain(img, pad=8):
    """The plain version on the image wrap-padded by `pad`, cropped back:
    K1's function with every stage wrapping at the edges, as the kernel
    does (the plain version pads its box sums with zeros and its nonmax
    with -inf)."""
    x = torch.nn.functional.pad(img[:, None], (pad,) * 4, mode="circular")
    r, b = fast_harris_rank_map_plain(x[:, 0])
    return r[:, pad:-pad, pad:-pad], b[:, pad:-pad, pad:-pad]


def _k1_input(cuda, scene, shape):
    if shape == "scene":
        return scene[3]["atlas"].contiguous()
    if shape == "chunk":
        frames, _, _ = make_sequence(9, 376, 1241, seed=0)
        o = EstimatorConfig().orb
        return atlas_keypoints(torch.from_numpy(frames).to(cuda), o.nfeatures,
                               o.nlevels, o.scale_factor, o.fast_threshold,
                               o.max_kpts)["atlas"].contiguous()
    if shape in ("level0", "level11"):
        # the per-level path's (RPE_NO_ATLAS) inputs: pyramid levels of the
        # 9 frames, 376x1241 and 132x435
        frames, _, _ = make_sequence(9, 376, 1241, seed=0)
        levels = build_pyramid(torch.from_numpy(frames).to(cuda), 12, 1.1)
        return levels[int(shape[5:])].contiguous()
    f, h, w = shape
    g = np.random.default_rng(h * w)
    img = np.repeat(np.repeat(g.uniform(0, 255, (f, h // 2 + 1, w // 2 + 1)),
                              2, 1), 2, 2)[:, :h, :w]
    return torch.from_numpy(img.astype(np.float32)).to(cuda)


@pytest.mark.parametrize("shape", ["scene", (2, 203, 517), (1, 9, 9),
                                   "chunk", "level0", "level11"],
                         ids=["scene", "ragged-203x517", "min-9x9",
                              "chunk-9x3200x1280", "level0-9x376x1241",
                              "level11-9x132x435"])
def test_fast_harris_kernel_matches_plain(scene, cuda, shape):
    """K1 is bit-equal to its plain version 8 px and more from the edges,
    and over the whole image to the plain version with every stage
    wrapping (the edge tiles' path); one launch. Prints how many edge-band
    pixels differ from the unpadded plain version (its zero and -inf
    padding)."""
    atlas = _k1_input(cuda, scene, shape)
    n0 = kernels.LAUNCHES["fast_harris"]
    rk, bk = fast_harris_rank_map(atlas, 15.0)
    assert kernels.LAUNCHES["fast_harris"] == n0 + 1
    rp, bp = fast_harris_rank_map_plain(atlas, 15.0)
    m = 8
    assert torch.equal(rk[:, m:-m, m:-m], rp[:, m:-m, m:-m])
    assert torch.equal(bk[:, m:-m, m:-m], bp[:, m:-m, m:-m])
    rw, bw = _wrapped_plain(atlas)
    assert torch.equal(rk, rw) and torch.equal(bk, bw)
    assert bool(torch.isfinite(rk).any()) or atlas.shape[-1] < 16
    print(f"K1 {tuple(atlas.shape)}: edge band differs from the unpadded "
          f"plain version on {int((rk != rp).sum())} rank and "
          f"{int((bk != bp).sum())} blur px of {rk.numel()}")


def test_fast_harris_kernel_refuses_negative_threshold(cuda):
    """The kernel takes FAST's bright and dark masks as exclusive, which
    needs threshold >= 0; the wrapper refuses others, launching nothing."""
    img = torch.zeros((1, 16, 16), device=cuda)
    n0 = kernels.LAUNCHES["fast_harris"]
    with pytest.raises(ValueError, match="threshold"):
        fast_harris_rank_map(img, -1.0)
    assert kernels.LAUNCHES["fast_harris"] == n0


def _slot_args(kp):
    """The extraction kernels' inputs at band 32, cap 72, and the live-slot
    mask (1, S)."""
    _, ha, wp = kp["atlas"].shape
    tb = band_tables(ha, wp, kp["xy_atlas"], kp["valid"], cap=72, band=32)
    live = (tb["rel_y"] >= 0).reshape(1, -1)
    return (kp["atlas"], kp["blurred"], tb["tbl_x0"], tb["rel_y"], 32), live


@pytest.mark.parametrize("binned", [False, True], ids=["k2", "k12_binned"])
def test_extract_brief_kernel_matches_plain(scene, binned):
    """K2 and K12: bits agree >= 0.999 with the plain version, moments
    within rtol 1e-4, atol 2, parked slots zero; one launch."""
    name = "extract_brief_binned" if binned else "extract_brief"
    args, live = _slot_args(scene[3])
    n0 = kernels.LAUNCHES[name]
    bk, m10k, m01k = extract_brief(*args, binned=binned)
    bp, m10p, m01p = extract_brief_plain(*args, binned=binned)
    assert kernels.LAUNCHES[name] == n0 + 1
    assert float((bk == bp)[live].float().mean()) >= 0.999
    torch.testing.assert_close(m10k, m10p, rtol=1e-4, atol=2.0)
    torch.testing.assert_close(m01k, m01p, rtol=1e-4, atol=2.0)
    assert not bk[~live].any() and not m10k[~live].any()


BRIEF_MODES = [("cv2", True), ("gauss", True), ("cv2", False)]


@pytest.mark.parametrize("kind,quant", BRIEF_MODES,
                         ids=["cv2-quant", "gauss-quant", "cv2"])
@pytest.mark.parametrize("binned", [False, True], ids=["k2", "k12_binned"])
def test_extract_brief_kernel_modes_match_plain(scene, binned, kind, quant):
    """K2 and K12 in the modes RPE_BRIEF and RPE_BRIEF_QUANT ask for (the
    wide sample radius for OpenCV's pattern, rounded samples) against
    their plain versions in the same mode: bits >= 0.999, moments within
    rtol 1e-4, atol 2, parked slots zero; one launch; the mode's bits
    differ from the default mode's."""
    name = "extract_brief_binned" if binned else "extract_brief"
    args, live = _slot_args(scene[3])
    n0 = kernels.LAUNCHES[name]
    bk, m10k, m01k = extract_brief(*args, binned=binned, quant=quant,
                                   kind=kind)
    bp, m10p, m01p = extract_brief_plain(*args, binned=binned, quant=quant,
                                         kind=kind)
    assert kernels.LAUNCHES[name] == n0 + 1
    assert float((bk == bp)[live].float().mean()) >= 0.999
    torch.testing.assert_close(m10k, m10p, rtol=1e-4, atol=2.0)
    torch.testing.assert_close(m01k, m01p, rtol=1e-4, atol=2.0)
    assert not bk[~live].any() and not m10k[~live].any()
    default = extract_brief(*args, binned=binned, quant=False,
                            kind="gauss")[0]
    assert bool((bk != default)[live].any())


def _edge_slots(cuda, f, seed=3, nb=8, cap=72):
    """The extraction kernels' inputs on seeded (f, nb * 32, 320) atlases at
    band 32, cap 72 and 8 bands unless given, with the slot layouts that
    stress a warp per slot:
    band 0 all live, band 1 all parked, band 2's 12 live slots over a
    constant raw region (zero moments), the last band's slots at the right
    and bottom edges (x0 = WP - 31, y0 = HA - 31), at x0 = 0, and two past
    the edges (rows and columns clamp, as the plain version's gather); the
    other bands live first, then parked, as `band_tables` fills them.
    Returns (args, live, constant-raw slots, last-band slots), masks (F, S).
    """
    g = np.random.default_rng(seed)
    wp, band, p = 320, 32, 31
    ha = nb * band
    atlas = g.uniform(0, 255, (f, ha, wp)).astype(np.float32)
    atlas[:, 64:127, :100] = 77.0
    blur = g.uniform(0, 255, (f, ha, wp)).astype(np.float32)
    x0 = g.integers(0, wp - p + 1, (f, nb, cap))
    ry = g.integers(0, band, (f, nb, cap))
    n_live = g.integers(0, cap + 1, (f, nb))
    n_live[:, 0], n_live[:, 1], n_live[:, 2] = cap, 0, 12
    x0[:, 2, :12] = g.integers(0, 70, (f, 12))
    last = nb - 1
    n_live[:, last] = 8
    x0[:, last, :4], ry[:, last, :4] = wp - p, ha - p - last * band
    x0[:, last, 4] = 0
    x0[:, last, 5], ry[:, last, 5] = wp - p, 0
    x0[:, last, 6:8], ry[:, last, 6:8] = wp - 5, band - 1
    ry = np.where(np.arange(cap) < n_live[..., None], ry, -31)
    const = np.zeros((f, nb, cap), bool)
    const[:, 2, :12] = True
    edge = np.zeros((f, nb, cap), bool)
    edge[:, last, :8] = True
    args = (torch.from_numpy(atlas).to(cuda), torch.from_numpy(blur).to(cuda),
            torch.from_numpy(x0.astype(np.int32)).to(cuda),
            torch.from_numpy(ry.astype(np.int32)).to(cuda), band)
    return args, *(torch.from_numpy(m.reshape(f, -1)).to(cuda)
                   for m in (ry >= 0, const, edge))


@pytest.mark.parametrize("f", [1, 9])
@pytest.mark.parametrize("binned", [False, True], ids=["k2", "k12_binned"])
def test_extract_brief_kernel_edge_slots(cuda, binned, f):
    """K2 and K12 on `_edge_slots`: the contract of
    test_extract_brief_kernel_matches_plain on all live slots and on the
    last band's alone; on constant raw patches moments exactly 0 and bits
    equal to the plain version's (angle 0, bin 0); one launch."""
    name = "extract_brief_binned" if binned else "extract_brief"
    args, live, const, edge = _edge_slots(cuda, f)
    n0 = kernels.LAUNCHES[name]
    bk, m10k, m01k = extract_brief(*args, binned=binned)
    bp, m10p, m01p = extract_brief_plain(*args, binned=binned)
    assert kernels.LAUNCHES[name] == n0 + 1
    assert bk.shape == (f, 8 * 72, 256) and bk.dtype == torch.uint8
    for m in (live, edge):
        assert float((bk == bp)[m].float().mean()) >= 0.999
    torch.testing.assert_close(m10k, m10p, rtol=1e-4, atol=2.0)
    torch.testing.assert_close(m01k, m01p, rtol=1e-4, atol=2.0)
    assert not bk[~live].any() and not m10k[~live].any() \
        and not m01k[~live].any()
    for m in (m10k, m01k, m10p, m01p):
        assert not m[const].any()
    assert torch.equal(bk[const], bp[const])


@pytest.mark.parametrize("binned", [False, True], ids=["k2", "k12_binned"])
def test_extract_brief_kernel_nan_moments(cuda, binned):
    """A raw region of NaN (a non-finite atlas given to the wrapper): the
    slots over it get NaN moments and steer as zero moments do (angle 0,
    bin 0), so their bits equal the plain version's over the same slots
    with the region constant; parked slots stay zero."""
    args, live, const, _ = _edge_slots(cuda, 2)
    nan_atlas = args[0].clone()
    nan_atlas[:, 64:127, :100] = float("nan")
    bk, m10k, m01k = extract_brief(nan_atlas, *args[1:], binned=binned)
    bp = extract_brief_plain(*args, binned=binned)[0]
    assert torch.isnan(m10k[const]).all() and torch.isnan(m01k[const]).all()
    assert torch.equal(bk[const], bp[const])
    assert not bk[~live].any() and not m10k[~live].any()


PATCH_KERNELS = ["extract_patches", "extract_patches_moments",
                 "extract_patches_t"]


@pytest.mark.parametrize("name", PATCH_KERNELS)
def test_patch_kernels_match_plain(scene, name):
    """K8, K9, K10: patches identical, moments as K2's, parked slots zero;
    one launch each."""
    args, live = _slot_args(scene[3])
    n0 = kernels.LAUNCHES[name]
    got = getattr(textract, name)(*args)
    want = getattr(textract, name + "_plain")(*args)
    assert kernels.LAUNCHES[name] == n0 + 1
    assert torch.equal(got[0], want[0]) and got[0].is_cuda
    if name == "extract_patches":
        assert torch.equal(got[1], want[1])
    else:
        torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=2.0)
        torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=2.0)
    assert not got[0][~live].any() and not got[1][~live].any()


@pytest.mark.parametrize("f,nb,cap", [(1, 8, 72), (2, 8, 72), (1, 7, 71),
                                      (2, 7, 71)],
                         ids=["f1", "f2", "f1_cap71", "f2_cap71"])
@pytest.mark.parametrize("name", PATCH_KERNELS)
def test_patch_kernels_edge_slots(cuda, name, f, nb, cap):
    """K8, K9, K10 on `_edge_slots` (live, parked, constant-raw and
    past-edge slots; at cap 71 with 7 bands, F * NB * CAP is not a multiple
    of 4): patches identical to the plain version's, moments within rtol
    1e-4, atol 2 and equal to K2's on the same tables (exactly 0 on
    constant raw patches), parked slots zero; one launch."""
    args, live, const, edge = _edge_slots(cuda, f, nb=nb, cap=cap)
    n0 = kernels.LAUNCHES[name]
    got = getattr(textract, name)(*args)
    want = getattr(textract, name + "_plain")(*args)
    assert kernels.LAUNCHES[name] == n0 + 1
    assert got[0].shape == (f, nb * cap, 31, 31)
    assert torch.equal(got[0], want[0])
    for t in got:
        assert not t[~live].any()
    if name == "extract_patches":
        assert torch.equal(got[1], want[1])
        return
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=2.0)
    torch.testing.assert_close(got[2], want[2], rtol=1e-4, atol=2.0)
    assert not got[1][const].any() and not got[2][const].any()
    _, m10, m01 = extract_brief(*args)
    assert torch.equal(got[1], m10) and torch.equal(got[2], m01)


ROOT_BATCHES = [1, 31, 33, 256, 2047, 2048, 2049]


def _random_coeffs(cuda, b, seed=9):
    """K4's input from b minimal samples of uniform random points."""
    g = np.random.default_rng(seed)
    pts = torch.from_numpy(g.uniform(-0.5, 0.5, (b, 5, 2, 2)).astype(
        np.float32)).to(cuda)
    _, c = fp.constraint_coeffs(pts[..., 0], pts[..., 1])
    return c.contiguous()


def _diagonal_coeffs(cuda, noisy):
    """One hypothesis whose M(z) is the identity (det M = 1: no root), or,
    with `noisy`, the identity with its last 2 x 2 block [[1, z], [z^2,
    z^3]]: the last pivot is z^3 - z^2 z, which the kernel's fused
    multiply-add leaves at the rounding error of z^2 z, so det M's sign
    flips at grid points far more than 10 times."""
    gm = fp._kernel_tables()[0]
    c = np.zeros((1, 10, 20), np.float32)
    for g in range(10):
        c[0, g, gm[g, 0]] = 1.0
    if noisy:
        c[0, 8, gm[9, 1]] = 1.0       # M[8][9] = z
        c[0, 9, gm[8, 2]] = 1.0       # M[9][8] = z^2
        c[0, 9, gm[9, 0]] = 0.0
        c[0, 9, gm[9, 3]] = 1.0       # M[9][9] = z^3
    return torch.from_numpy(c).to(cuda)


@pytest.mark.parametrize("b", ROOT_BATCHES)
def test_root_brackets_kernel_matches_plain(cuda, b):
    """K5 (tests/test_pallas_kernels.py:92-140) over batches with ragged
    warps and blocks: up to B = 256 identical has_root, endpoints within
    one grid step, >= 90% within two bisection widths; beyond it the plain
    version in float64 arbitrates, as in chip_smoke.py: the kernel is wrong
    (has_root or an endpoint more than a grid step off) on no more slots
    than the float32 plain version, and >= 90% of its endpoints lie within
    two bisection widths. One launch; empty slots zero."""
    c = _random_coeffs(cuda, b)
    n0 = kernels.LAUNCHES["root_brackets"]
    lo, hi, has = fp.find_root_brackets(c)
    assert kernels.LAUNCHES["root_brackets"] == n0 + 1
    lo_p, hi_p, has_p = fp.find_root_brackets_plain(c)
    dt = float(np.pi / (fp.GRID - 1))
    width = dt / (1 << fp.BISECT_ITERS)

    def judge(x, ref):
        both = x[2] & ref[2]
        dlo, dhi = (x[0] - ref[0]).abs(), (x[1] - ref[1]).abs()
        wrong = int((x[2] != ref[2]).sum()
                    + (both & ((dlo > dt) | (dhi > dt))).sum())
        near = both & (dlo <= 2 * width) & (dhi <= 2 * width)
        return wrong, float(near.sum()) / max(int(both.sum()), 1)

    if b <= 256:
        wrong, near = judge((lo, hi, has), (lo_p, hi_p, has_p))
        assert torch.equal(has, has_p) and int(has.sum()) >= b
        assert wrong == 0 and near > 0.9
    else:
        f64 = [x.float() if x.is_floating_point() else x
               for x in fp.find_root_brackets_plain(c.double())]
        k_wrong, k_near = judge((lo, hi, has), f64)
        assert k_wrong <= judge((lo_p, hi_p, has_p), f64)[0]
        assert k_near >= 0.9
    assert not lo[~has].any() and not hi[~has].any()


@pytest.mark.parametrize("noisy", [False, True], ids=["no_root", "capped"])
def test_root_brackets_kernel_odd_hypotheses(cuda, noisy):
    """A hypothesis without a root gets empty slots; one with more than 10
    sign changes keeps the first 10 in grid order (the `cnt < NR` cap). In
    a batch of 65 the others get the brackets they get alone, and K4 marks
    the same slots."""
    odd = _diagonal_coeffs(cuda, noisy)
    rest = _random_coeffs(cuda, 64)
    c = torch.cat([rest[:40], odd, rest[40:]]).contiguous()
    lo, hi, has = fp.find_root_brackets(c)
    alone = fp.find_root_brackets(rest)
    keep = torch.arange(65, device=cuda) != 40
    for x, y in zip((lo, hi, has), alone):
        assert torch.equal(x[keep], y)
    if noisy:
        assert bool(has[40].all())
        assert bool((lo[40, 1:] > hi[40, :-1]).all())
        assert bool((hi[40] - lo[40] < 1e-3).all())
    else:
        assert not has[40].any() and not lo[40].any() and not hi[40].any()
    assert torch.equal(fp.solve_roots_polished(c)[4], has)


# (P, N1, N2, kind): ragged edges of the kernel's 256-row and 128-column
# tiles, the chunk's shape, every cell tied, and pairs without valid rows
HAMMING_CASES = [(2, 512, 512, "random"), (2, 300, 457, "random"),
                 (2, 129, 1000, "random"), (2, 1, 257, "random"),
                 (8, 4096, 4096, "random"), (2, 300, 457, "identical"),
                 (3, 300, 457, "no_valid_rows")]
HAMMING_IDS = [f"{p}x{n1}x{n2}-{kind}" for p, n1, n2, kind in HAMMING_CASES]


def _hamming_inputs(cuda, seed, p, n1, n2, kind, tied_best=False):
    """{0,1} descriptors of P pairs with near-duplicates (ties); the last
    pair has no valid columns. "identical": every descriptor of both sides
    equal, so every cell ties across tiles and CTAs; "no_valid_rows": pair
    0 has no valid rows."""
    g = np.random.default_rng(seed)
    b1 = torch.from_numpy(g.uniform(size=(p, n1, 256)) < 0.5).to(torch.uint8)
    b2 = torch.from_numpy(g.uniform(size=(p, n2, 256)) < 0.5).to(torch.uint8)
    m = min(n1, n2 // 2)
    b2[:, :m, 16:] = b1[:, :m, 16:]                     # near-duplicates, ties
    if tied_best:
        b2[:, n2 // 2:n2 // 2 + 8] = b2[:, :8]         # best tied at 2 columns
    if kind == "identical":
        b1[:] = b1[:1, :1]
        b2[:] = b1[:1, :1]
    v1 = torch.from_numpy(g.uniform(size=(p, n1)) < 0.9)
    v2 = torch.from_numpy(g.uniform(size=(p, n2)) < 0.9)
    v2[-1] = False                                     # no valid columns
    if kind == "no_valid_rows":
        v1[0] = False
    return [t.to(cuda) for t in (b1, b2, v1, v2)]


@pytest.mark.parametrize("p,n1,n2,kind", HAMMING_CASES, ids=HAMMING_IDS)
def test_match_hamming_kernel_identical(cuda, p, n1, n2, kind):
    b1, b2, v1, v2 = _hamming_inputs(cuda, n1 + n2, p, n1, n2, kind)
    n0 = kernels.LAUNCHES["match_hamming"]
    got = mutual_nn_hamming(b1, b2, v1, v2)
    assert kernels.LAUNCHES["match_hamming"] == n0 + 1
    for k, w in zip(got, mutual_nn_hamming_plain(b1, b2, v1, v2)):
        assert torch.equal(k, w)


@pytest.mark.parametrize("p,n1,n2,kind", HAMMING_CASES, ids=HAMMING_IDS)
def test_row_top2_hamming_kernel_identical(cuda, p, n1, n2, kind):
    b1, b2, v1, v2 = _hamming_inputs(cuda, n1 * n2, p, n1, n2, kind,
                                     tied_best=True)
    n0 = kernels.LAUNCHES["row_top2_hamming"]
    got = row_top2(b1, b2, v1, v2, "hamming")
    assert kernels.LAUNCHES["row_top2_hamming"] == n0 + 1
    for k, w in zip(got, row_top2_plain(b1, b2, v1, v2, "hamming")):
        assert torch.equal(k, w)


# (P, N1, N2, kind): the earlier shapes, ragged edges of the kernel's
# 128-row and 128-column tiles, the chunk's shape, every cell tied, a pair
# without valid rows, and valid columns forming a prefix (the later column
# tiles are skipped)
L2_CASES = [(2, 512, 512, "random"), (2, 300, 457, "random"),
            (2, 129, 1000, "random"), (2, 1, 257, "random"),
            (8, 4096, 4096, "random"), (2, 300, 457, "identical"),
            (3, 300, 457, "no_valid_rows"), (2, 300, 1000, "prefix")]
L2_IDS = [f"{p}x{n1}x{n2}-{kind}" for p, n1, n2, kind in L2_CASES]


def _float_descriptors(cuda, seed, p, n1, n2, kind):
    """SIFT-like descriptors of P pairs with distance-0 ties; the last
    pair's first half of columns invalid. "identical": every descriptor of
    both sides equal, so every cell ties across tiles and CTAs;
    "no_valid_rows": pair 0 has no valid rows; "prefix": only the first
    quarter of each pair's columns may be valid."""
    d1, d2, v1, v2 = float_descriptors(seed, n1, n2, pairs=p, dup=True)
    v2[-1, : n2 // 2] = False
    if kind == "identical":
        d1[:] = d1[:1, :1]
        d2[:] = d1[:1, :1]
    if kind == "no_valid_rows":
        v1[0] = False
    if kind == "prefix":
        v2[:, n2 // 4:] = False
    return [torch.from_numpy(a).to(cuda) for a in (d1, d2, v1, v2)]


def _first_valid(v):
    """Index of each pair's first True (P,), 0 where none."""
    return torch.argmax(v.to(torch.int32), dim=-1)


def _masked_l2(cuda, d1, d2, v1, v2):
    return torch.where(v1[..., :, None] & v2[..., None, :],
                       l2sq_distance_matrix(d1, d2),
                       torch.tensor(BIG, device=cuda))


@pytest.mark.parametrize("p,n1,n2,kind", L2_CASES, ids=L2_IDS)
def test_match_l2_kernel_matches_plain(cuda, p, n1, n2, kind):
    """K7 against its plain version: distances within 1e-5, index
    differences only on near-ties (`near_tie_ok`), canonical outputs of
    invalid rows and columns, one launch; exact ties go to the lowest
    index."""
    d1, d2, v1, v2 = _float_descriptors(cuda, n1 + 7 * n2, p, n1, n2, kind)
    Dm = _masked_l2(cuda, d1, d2, v1, v2)
    n0 = kernels.LAUNCHES["match_l2"]
    k = mutual_nn_l2(d1, d2, v1, v2)
    assert kernels.LAUNCHES["match_l2"] == n0 + 1
    pl = mutual_nn_l2_plain(d1, d2, v1, v2)
    assert k[1].dtype == torch.int32 and k[0].dtype == torch.float32
    if bool(v1.any()):
        assert float((k[0] - pl[0])[v1].abs().max()) <= 1e-5
    assert (k[0][~v1] == BIG).all() and (k[1][~v1] == 0).all()
    assert (k[2][~v2] == 0).all()
    rows = v1 & (pl[0] < BIG)
    cols = v2 & (Dm.min(dim=-2).values < BIG)
    assert near_tie_ok(argmin_mismatches(Dm, k[1], pl[1], rows, -1))
    assert near_tie_ok(argmin_mismatches(Dm, k[2], pl[2], cols, -2))
    if kind == "identical":
        first2 = _first_valid(v2)[:, None].expand_as(k[1])
        first1 = _first_valid(v1)[:, None].expand_as(k[2])
        assert torch.equal(k[1][rows], first2[rows].to(torch.int32))
        assert torch.equal(k[2][cols], first1[cols].to(torch.int32))


@pytest.mark.parametrize("p,n1,n2,kind", L2_CASES, ids=L2_IDS)
def test_row_top2_l2_kernel_matches_plain(cuda, p, n1, n2, kind):
    """K6-L2 against its plain version: d1 and d2 within 1e-5, index
    differences only on near-ties, (_BIG, 0, _BIG) for invalid rows, one
    launch; an exact tie gives the lowest index and d2 == d1."""
    d1, d2, v1, v2 = _float_descriptors(cuda, n1 + 5 * n2, p, n1, n2, kind)
    Dm = _masked_l2(cuda, d1, d2, v1, v2)
    n0 = kernels.LAUNCHES["row_top2_l2"]
    k = row_top2(d1, d2, v1, v2, "l2")
    assert kernels.LAUNCHES["row_top2_l2"] == n0 + 1
    pl = row_top2_plain(d1, d2, v1, v2, "l2")
    for a, b in ((k[0], pl[0]), (k[2], pl[2])):
        if bool(v1.any()):
            assert float((a - b)[v1].abs().max()) <= 1e-5
        assert (a[~v1] == BIG).all()
    assert (k[1][~v1] == 0).all()
    rows = v1 & (pl[0] < BIG)
    assert near_tie_ok(argmin_mismatches(Dm, k[1], pl[1], rows, -1))
    if kind == "identical":
        first2 = _first_valid(v2)[:, None].expand_as(k[1])
        assert torch.equal(k[1][rows], first2[rows].to(torch.int32))
        two = rows & (v2.sum(-1) >= 2)[:, None]
        assert torch.equal(k[2][two], k[0][two])


@pytest.mark.parametrize("b", ROOT_BATCHES)
def test_five_point_kernel_roots(cuda, b):
    """K4 over batches with ragged warps and blocks: its roots include >=
    95% of the plain version's, |z| < 1.2e3, zero outputs where no root;
    one launch."""
    c = _random_coeffs(cuda, b)
    n0 = kernels.LAUNCHES["five_point_roots"]
    xk, yk, rk, fk, hk = fp.solve_roots_polished(c)
    assert kernels.LAUNCHES["five_point_roots"] == n0 + 1
    xp, yp, rp, fpl, hp = fp.solve_roots_plain(c)
    assert hk.sum() >= b
    zk = torch.where(fk, 1.0 / torch.where(rk.abs() > 1e-12, rk, 1.0), rk)
    zp = torch.where(fpl, 1.0 / torch.where(rp.abs() > 1e-12, rp, 1.0), rp)
    assert float(zk[hk].abs().max()) < 1.2e3
    near = (zk[:, None, :] - zp[:, :, None]).abs() <= 1e-3 * torch.clamp_min(
        zp.abs(), 1.0)[..., None]
    found = (near & hk[:, None, :]).any(-1)
    assert float(found[hp].float().mean()) >= 0.95
    assert not xk[~hk].any() and not yk[~hk].any()


ORB_KERNELS = {"fast_harris", "extract_brief", "five_point_roots"}


@pytest.mark.parametrize("cfg,expect", [
    (SMALL, ORB_KERNELS | {"match_hamming"} | GEOMETRY),
    (SIFT_A, {"match_l2", "five_point_roots"} | GEOMETRY | SIFT_KERNELS),
    (SIFT_B, {"row_top2_l2", "five_point_roots"} | GEOMETRY | SIFT_KERNELS),
    (ORB_RATIO, ORB_KERNELS | {"row_top2_hamming"} | GEOMETRY),
], ids=["orb", "sift_a", "sift_b", "orb_ratio"])
def test_main_path_launches_every_kernel_and_agrees_with_cpu(
        scene, cuda, cfg, expect):
    """Each path launches exactly its kernels (no plain version, no CPU)
    and agrees with its CPU run."""
    frames, K, R_gt, _ = scene
    keys = torch.stack([rng.PRNGKey(i) for i in range(2)])
    kernels.reset_launches()
    out = estimate_sequence_batched(frames, K, keys, cfg)
    assert {k for k, n in kernels.LAUNCHES.items() if n > 0} == expect, \
        kernels.LAUNCHES
    assert out["R"].is_cuda and bool(torch.isfinite(out["R"]).all())
    cpu = estimate_sequence_batched(frames, K, keys, cfg, device="cpu")
    assert torch.equal(out["valid"].cpu(), cpu["valid"])
    assert rotation_error_deg(out["R"].cpu().numpy(),
                              cpu["R"].numpy()).max() <= 0.5
    assert rotation_error_deg(out["R"].cpu().numpy(), R_gt[None]).max() < 2.0


ROUTES = {  # the reference's gates -> the extraction kernel they select
    "extract_brief_binned": {"RPE_EXTRACT_T_V7": "1"},
    "extract_patches_t": {"RPE_EXTRACT_T_BRIEF": "0"},
    "extract_patches_moments": {"RPE_EXTRACT_T": "0"},
    "extract_patches": {"RPE_EXTRACT_T": "0", "RPE_EXTRACT_MOMENTS": "0"},
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_paths_launch_their_kernel_and_agree_with_cpu(
        scene, cuda, monkeypatch, route):
    """Under each route's gates the ORB path launches its extraction kernel
    in place of K2 and agrees with its CPU run."""
    frames, K, R_gt, _ = scene
    for k, v in ROUTES[route].items():
        monkeypatch.setenv(k, v)
    keys = torch.stack([rng.PRNGKey(i) for i in range(2)])
    kernels.reset_launches()
    out = estimate_sequence_batched(frames, K, keys, SMALL)
    assert {k for k, n in kernels.LAUNCHES.items() if n > 0} == {
        "fast_harris", route, "match_hamming",
        "five_point_roots"} | GEOMETRY, \
        kernels.LAUNCHES
    cpu = estimate_sequence_batched(frames, K, keys, SMALL, device="cpu")
    assert torch.equal(out["valid"].cpu(), cpu["valid"])
    assert rotation_error_deg(out["R"].cpu().numpy(),
                              cpu["R"].numpy()).max() <= 0.5
    assert rotation_error_deg(out["R"].cpu().numpy(), R_gt[None]).max() < 2.0


SWITCHES = {  # the reference's switches -> the kernels their path launches
    "no_atlas": ({"RPE_NO_ATLAS": "1"}, {"fast_harris": SMALL.orb.nlevels,
                                         "match_hamming": 1,
                                         "five_point_roots": 1}),
    "no_fused_atlas": ({"RPE_NO_FUSED_ATLAS": "1"}, None),
    "cv2": ({"RPE_BRIEF": "cv2"}, None),
    "cv2_v7": ({"RPE_BRIEF": "cv2", "RPE_EXTRACT_T_V7": "1"},
               {"fast_harris": 1, "extract_brief_binned": 1,
                "match_hamming": 1, "five_point_roots": 1}),
    "quant": ({"RPE_BRIEF_QUANT": "1"}, None),
    "lo": ({}, None),
}


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_switch_paths_launch_their_kernels_and_agree_with_cpu(
        scene, cuda, monkeypatch, switch):
    """Under each of the reference's switches (and RansacConfig(lo=True))
    the ORB path launches exactly its kernels, each as often as stated
    (the default ORB path's K1-K4 once each unless given), and agrees
    with its CPU run."""
    frames, K, R_gt, _ = scene
    env, want = SWITCHES[switch]
    want = want or {k: 1 for k in ORB_KERNELS | {"match_hamming"}}
    want = want | geometry(1, lo=switch == "lo")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = SMALL if switch != "lo" else dataclasses.replace(
        SMALL, ransac=dataclasses.replace(SMALL.ransac, lo=True))
    keys = torch.stack([rng.PRNGKey(i) for i in range(2)])
    kernels.reset_launches()
    out = estimate_sequence_batched(frames, K, keys, cfg)
    assert {k: n for k, n in kernels.LAUNCHES.items() if n} == want, \
        kernels.LAUNCHES
    cpu = estimate_sequence_batched(frames, K, keys, cfg, device="cpu")
    assert torch.equal(out["valid"].cpu(), cpu["valid"])
    assert rotation_error_deg(out["R"].cpu().numpy(),
                              cpu["R"].numpy()).max() <= 0.5
    assert rotation_error_deg(out["R"].cpu().numpy(), R_gt[None]).max() < 2.0


SOLVER_PROFILES = {  # RansacConfig(solver="8pt") and the ORB profiles
    "8pt": (dataclasses.replace(SMALL, ransac=dataclasses.replace(
        SMALL.ransac, solver="8pt")),
        {"fast_harris": 1, "extract_brief": 1, "match_hamming": 1}
        | kernels.geometry_launches(1, "8pt")),
    "orb2000": (profile_config("orb2000"), None),
    "orb1000": (profile_config("orb1000"), None),
}


@pytest.mark.parametrize("name", list(SOLVER_PROFILES))
def test_solver_and_profile_paths_launch_their_kernels_and_agree_with_cpu(
        scene, cuda, name):
    """The 8-point solver (no K4, no P1) and the orb2000 and orb1000
    profiles launch exactly their kernels, agree with their CPU run, and
    give the same bits for their 2 pairs in one call and in two."""
    frames, K, R_gt, _ = scene
    cfg, want = SOLVER_PROFILES[name]
    want = want or {k: 1 for k in ORB_KERNELS | {"match_hamming"}} | \
        geometry(1)
    keys = torch.stack([rng.PRNGKey(i) for i in range(2)])
    kernels.reset_launches()
    out = estimate_sequence_batched(frames, K, keys, cfg)
    assert {k: n for k, n in kernels.LAUNCHES.items() if n} == want, \
        kernels.LAUNCHES
    cpu = estimate_sequence_batched(frames, K, keys, cfg, device="cpu")
    assert torch.equal(out["valid"].cpu(), cpu["valid"])
    assert rotation_error_deg(out["R"].cpu().numpy(),
                              cpu["R"].numpy()).max() <= 0.5
    assert rotation_error_deg(out["R"].cpu().numpy(), R_gt[None]).max() < 2.0
    parts = [estimate_sequence_batched(frames[a:a + 2], K, keys[a:a + 1], cfg)
             for a in range(2)]
    for k in ("R", "t", "valid", "num_inliers", "num_matches"):
        assert torch.equal(torch.cat([q[k] for q in parts]), out[k]), k


def test_sift_entry_points_run_on_the_card(scene, cuda):
    """estimate_pairs_batched, estimate_pair and PoseEstimator(SIFT, L2)
    take the card by default and launch K7 there."""
    frames, K, R_gt, _ = scene
    kernels.reset_launches()
    out = estimate_pairs_batched(frames[:2], frames[1:], K,
                                 torch.stack([rng.PRNGKey(i)
                                              for i in range(2)]), SIFT_A)
    assert out["R"].is_cuda and out["valid"].all()
    one = estimate_pair(frames[0], frames[1], K, rng.PRNGKey(0), SIFT_A)
    assert one["R"].shape == (3, 3) and one["R"].is_cuda
    est = PoseEstimator(K, feature_method="SIFT", norm_type="L2",
                        max_matches=256, config=SIFT_A)
    R, t = est.estimate(frames[0], frames[1])
    assert rotation_error_deg(R, R_gt) < 2.0 and t.shape == (3, 1)
    assert kernels.LAUNCHES["match_l2"] == 3
    assert kernels.LAUNCHES["match_hamming"] == 0


def test_kitti_runner_decodes_and_estimates_on_the_card(cuda, tmp_path):
    """The sequence runner from written PNGs on the card: every frame
    decoded natively, one launch each of K1-K4 per chunk (5 frames, chunk
    2: two chunks), every pair valid, and its per-pair poses within 0.5 deg
    of a CPU run's."""
    from rpe_tpu_torch.cli import run_kitti_sequence
    from rpe_tpu_torch.io import image_loader
    from rpe_tpu_torch.utils.synthetic import write_kitti_sequence

    frames, K, (R, t) = make_sequence(5, 240, 480, seed=2)
    images, poses, calib = write_kitti_sequence(tmp_path, frames, K, R, t)
    args = ["--images-dir", str(images), "--poses", str(poses), "--calib",
            str(calib), "--chunk", "2", "--nfeatures", "512"]
    image_loader.reset_decodes()
    kernels.reset_launches()
    out = run_kitti_sequence.main(args + [
        "--results-dir", str(tmp_path / "card"),
        "--checkpoint", str(tmp_path / "card.jsonl")])
    assert image_loader.DECODES == {"native": 5, "pil": 0}
    assert {k: n for k, n in kernels.LAUNCHES.items() if n} == {
        "fast_harris": 2, "extract_brief": 2, "match_hamming": 2,
        "five_point_roots": 2} | geometry(2), kernels.LAUNCHES
    assert out["n_pairs_valid"] == 4
    cpu = run_kitti_sequence.main(args + [
        "--results-dir", str(tmp_path / "cpu"),
        "--checkpoint", str(tmp_path / "cpu.jsonl")], device="cpu")
    assert cpu["n_pairs_valid"] == 4

    def rotations(path):
        recs = [json.loads(x) for x in path.read_text().splitlines()[1:]]
        return np.array([np.reshape(r["R"], (3, 3)) for r in
                         sorted(recs, key=lambda r: r["pair"])])

    assert rotation_error_deg(rotations(tmp_path / "card.jsonl"),
                              rotations(tmp_path / "cpu.jsonl")).max() <= 0.5


@pytest.fixture(scope="module")
def room():
    """A Manhattan room (utils/synthetic.py `GATED_ROOM`), 8 frames of
    376x1241: the default VP gates pass on every frame of it."""
    from rpe_tpu_torch.pipeline.calibration import CameraCalibration
    from rpe_tpu_torch.utils.synthetic import GATED_ROOM, manhattan_sequence

    frames, K, S, yaw, centres = manhattan_sequence(
        8, 376, 1241, seed=0, K=CameraCalibration().get_matrix(1241, 376),
        **GATED_ROOM)
    return np.clip(np.rint(frames), 0, 255).astype(np.float32), K


def test_vp_labels_card_against_cpu(cuda, room):
    """The 96-round labeling on the card against the CPU: CUDA's atanf can
    round a level-line angle the other way, so a pixel at the 22.5 deg gate
    may join another region; on this room no more than 1 in 10^4 labels
    differ, and the host twin's gate decisions are equal."""
    from rpe_tpu_torch.config import VpConfig
    from rpe_tpu_torch.geometry import vp_refine
    from rpe_tpu_torch.ops import lsd

    frames, K = room
    lab_card, _, mag_card = lsd._label_regions(
        torch.from_numpy(frames).to(cuda))
    lab_cpu, _, mag_cpu = lsd._label_regions(torch.from_numpy(frames))
    share = float((lab_card.cpu() != lab_cpu).float().mean())
    assert share <= 1e-4, share
    torch.testing.assert_close(mag_card.cpu(), mag_cpu, rtol=1e-6, atol=0)
    cfg = VpConfig(enabled=True)
    card = vp_refine.manhattan_dirs_for_frames(frames, K.astype(np.float64),
                                               cfg, device="cuda")
    cpu = vp_refine.manhattan_dirs_for_frames(frames, K.astype(np.float64),
                                              cfg, device="cpu")

    def gate(e):
        return bool(e[1] and e[2]["acc_max"] >= cfg.acc_min
                    and e[2]["vp2_score"] >= cfg.vp2_min)

    assert [gate(e) for e in card] == [gate(e) for e in cpu]
    assert all(gate(e) for e in card)


def test_vp_device_twin_card_against_cpu(cuda, room):
    """The tensor twin on the card against the CPU: the same gate decisions
    at the default gates, and acc_max within 5%. The card's scatter sums
    run in another order, so two lines of nearly equal length can swap
    places in the length order, and the sampled vote, which draws line
    indices, draws other pairs: the extreme-value statistics move by a few
    per cent (vp2_score 3.4% on this room). The refinement returns tensors
    on the card."""
    from rpe_tpu_torch.config import VpConfig
    from rpe_tpu_torch.geometry import vp_refine

    frames, K = room
    cfg = VpConfig(enabled=True)
    card = vp_refine.manhattan_dirs_for_frames_device(
        frames, K.astype(np.float64), cfg, device="cuda")
    cpu = vp_refine.manhattan_dirs_for_frames_device(
        frames, K.astype(np.float64), cfg, device="cpu")
    for a, b in zip(card, cpu):
        assert a[1] == b[1]
        np.testing.assert_allclose(a[2]["acc_max"], b[2]["acc_max"],
                                   rtol=5e-2)
        assert (a[2]["acc_max"] >= cfg.acc_min) == \
            (b[2]["acc_max"] >= cfg.acc_min)
        assert (a[2]["vp2_score"] >= cfg.vp2_min) == \
            (b[2]["vp2_score"] >= cfg.vp2_min)
    R_prev = np.eye(3, dtype=np.float32)
    R_rel = np.eye(3, dtype=np.float32)
    R, used, stats = vp_refine.refine_rotation_with_vps_device(
        frames[0], frames[1], R_prev, R_rel, K, cfg, device="cuda")
    assert R.is_cuda and used.is_cuda and stats["cost_opt"].is_cuda


@pytest.mark.parametrize("entries", [1, 2], ids=["one_card", "card_twice"])
def test_mesh_matches_the_run_without_a_mesh(scene, cuda, entries):
    """estimate_sequence_sharded on a one-card mesh (`pairs_mesh(1)`) and on
    the card listed twice: K1-K4 launched once per shard, and the outputs
    of the run without a mesh (`valid` and matches equal, R within
    1e-5)."""
    from rpe_tpu_torch.parallel.mesh import Mesh, pairs_mesh
    from rpe_tpu_torch.parallel.sharded_estimator import \
        estimate_sequence_sharded

    frames, K, _, _ = scene                       # 3 frames, 2 pairs
    keys = torch.stack([rng.PRNGKey(i) for i in range(2)])
    flat = estimate_sequence_batched(frames, K, keys, SMALL)
    mesh = pairs_mesh(1) if entries == 1 else Mesh(["cuda:0"] * 2,
                                                   ("pairs",))
    local = 2 // entries
    blocks = np.stack([np.arange(d * local, d * local + local + 1)
                       for d in range(entries)])
    kernels.reset_launches()
    out = estimate_sequence_sharded(frames[blocks], K,
                                    keys.reshape(entries, local, 2), SMALL,
                                    mesh)
    torch.cuda.synchronize()
    assert {k: n for k, n in kernels.LAUNCHES.items() if n} == {
        k: entries for k in ORB_KERNELS | {"match_hamming"}} | geometry(
            entries)
    out = {k: v.reshape(2, *v.shape[2:]) for k, v in out.items()}
    assert out["R"].device == mesh.devices.flat[0]
    assert torch.equal(out["valid"], flat["valid"])
    assert torch.equal(out["num_matches"], flat["num_matches"])
    assert float((out["R"] - flat["R"]).abs().max()) <= 1e-5


def _minimal_problems(m, seed):
    """m minimal problems of a random rigid motion each, 5 points with
    1e-3 noise: (m, 5, 2) x 2 on the card."""
    from rpe_tpu_torch.utils.synthetic import rotation_from_axis_angle

    g = np.random.default_rng(seed)
    p1s, p2s = [], []
    for _ in range(m):
        w = g.normal(size=3)
        R = rotation_from_axis_angle(
            w / np.linalg.norm(w) * np.deg2rad(g.uniform(2, 30)))
        t = g.normal(size=3)
        X = g.uniform([-2, -2, 3], [2, 2, 10], size=(5, 3))
        X2 = X @ R.T + t / np.linalg.norm(t)
        p1s.append((X / X[:, 2:3])[:, :2] + 1e-3 * g.normal(size=(5, 2)))
        p2s.append((X2 / X2[:, 2:3])[:, :2] + 1e-3 * g.normal(size=(5, 2)))
    return (torch.from_numpy(np.stack(a).astype(np.float32)).cuda()
            for a in (p1s, p2s))


@pytest.mark.parametrize("m", [1, 3, 31, 65, 256, 2047, 2048, 4096])
def test_coeffs_kernel_matches_plain_and_its_split(cuda, m):
    """P1 (csrc/five_point_coeffs.cu) in one launch, held as chip_smoke.py
    holds it (tests/torch_judges.py `p1_judge`): within 1e-5 of the
    float64 run on every hypothesis, and of the plain version where the
    plain float32 coefficients are within 1e-5 of their float64 run; the
    same bits when the batch is estimated in two calls."""
    p1, p2 = _minimal_problems(m, seed=m)
    n0 = kernels.LAUNCHES["five_point_coeffs"]
    null4, c = fp.constraint_coeffs(p1, p2)
    assert kernels.LAUNCHES["five_point_coeffs"] == n0 + 1
    _, c_p = fp.constraint_coeffs_plain(p1, p2)
    _, c_d = fp.constraint_coeffs_plain(p1.double(), p2.double())
    assert p1_judge(c, c_p, c_d)[0]
    h = m // 2
    parts = [fp.constraint_coeffs(p1[a:b], p2[a:b])
             for a, b in ((0, h), (h, m))]
    assert torch.equal(torch.cat([q[0] for q in parts]), null4)
    assert torch.equal(torch.cat([q[1] for q in parts]), c)


# (a shape, b shape) of P2's call sites at 8 pairs (geometry/_products.py
# `matmul`): the normal matrices, project_to_essential, decompose_essential,
# triangulate_depths and plane_parallax_essentials
P2_SITES = {
    "normal 8-point refit": ((8, 9, 500), (8, 500, 9)),
    "normal ambiguity": ((8, 16, 9, 500), (8, 16, 500, 9)),
    "normal DLT refit": ((8, 9, 1000), (8, 1000, 9)),
    "project EtE": ((8, 2560, 3, 3), (8, 2560, 3, 3)),
    "project E v": ((8, 2560, 3, 3), (8, 2560, 3, 1)),
    "decompose W Vt": ((3, 3), (8, 16, 3, 3)),
    "triangulate x2 R": ((8, 1, 1, 500, 3), (8, 16, 4, 3, 3)),
    "triangulate t R": ((8, 4, 1, 3), (8, 4, 3, 3)),
    "parallax x H^T": ((8, 64, 1, 3), (8, 1, 3, 3)),
}


@pytest.mark.parametrize("site", sorted(P2_SITES))
def test_fixed_order_bmm_matches_matmul_and_its_split(cuda, site):
    """P2 (csrc/fixed_order.cu) in one launch at a call site's shapes, held
    as chip_smoke.py holds it (tests/torch_judges.py `p2_judge`: within
    1e-6 of sum |a| |b| of the float64 product, and of torch.matmul where
    that is as close), and the same bits when the pairs are split in two
    calls."""
    from rpe_tpu_torch.geometry import _products as prods

    sa, sb = P2_SITES[site]
    g = np.random.default_rng(len(site))
    a = torch.from_numpy(g.normal(size=sa).astype(np.float32)).to(cuda)
    b = torch.from_numpy(g.normal(size=sb).astype(np.float32)).to(cuda)
    n0 = kernels.LAUNCHES["fixed_order_bmm"]
    got = prods.matmul(a, b)
    assert kernels.LAUNCHES["fixed_order_bmm"] == n0 + 1
    assert p2_judge(
        got, torch.matmul(a, b), torch.matmul(a.double(), b.double()),
        torch.matmul(a.abs().double(), b.abs().double()))[0]

    def cut(x, sl):
        return x[sl] if x.dim() == got.dim() and x.shape[0] == 8 else x

    parts = [prods.matmul(cut(a, sl), cut(b, sl))
             for sl in (slice(0, 4), slice(4, 8))]
    assert torch.equal(torch.cat(parts), got)


# the terms of P2's grouped and chained launches at 8 pairs
# (geometry/_products.py `matmuls`): (a, b) shapes for a @ b, (a, a2, b) for
# the chain a @ (a2 @ b)
P2_GROUPS = {
    "project E v0, E v1": (((8, 2560, 3, 3), (8, 2560, 3, 1)),
                           ((8, 2560, 3, 3), (8, 2560, 3, 1))),
    "project U (D Vt)": (((8, 2560, 3, 3), (8, 2560, 3, 3),
                          (8, 2560, 3, 3)),),
    "decompose U (W Vt), U (W^T Vt)": (((8, 16, 3, 3), (3, 3),
                                        (8, 16, 3, 3)),
                                       ((8, 16, 3, 3), (3, 3),
                                        (8, 16, 3, 3))),
    "triangulate x2 R, t R": (((8, 1, 1, 500, 3), (8, 16, 4, 3, 3)),
                              ((8, 16, 4, 1, 3), (8, 16, 4, 3, 3))),
    "parallax xa H^T, xb H^T": (((8, 64, 1, 3), (8, 1, 3, 3)),
                                ((8, 64, 1, 3), (8, 1, 3, 3))),
}


def _serial(t):
    return p2_serial(t[0], t[1]) if len(t) == 2 else p2_serial(
        t[0], t[2], a2=t[1])


@pytest.mark.parametrize("site", sorted(P2_GROUPS) + sorted(P2_SITES))
def test_fixed_order_launches_are_the_serial_reference(cuda, site):
    """Each grouped, chained or single P2 launch at a call site's shapes
    in one launch, every product bit-equal to the serial float64 loop over
    k (tests/torch_judges.py `p2_serial`), and to itself when the pairs
    are split in two calls."""
    from rpe_tpu_torch.geometry import _products as prods

    shapes = P2_GROUPS.get(site) or (P2_SITES[site],)
    g = np.random.default_rng(len(site))
    terms = [tuple(torch.from_numpy(g.normal(size=sh).astype(np.float32))
                   .to(cuda) for sh in t) for t in shapes]
    n0 = kernels.LAUNCHES["fixed_order_bmm"]
    got = prods.matmuls(*terms)
    assert kernels.LAUNCHES["fixed_order_bmm"] == n0 + 1
    for t, r in zip(terms, got):
        assert torch.equal(r, _serial(t))

    def cut(x, r, sl):
        return x[sl] if x.dim() == r.dim() and x.shape[0] == 8 else x

    parts = [prods.matmuls(*(tuple(cut(x, r, sl) for x in t)
                             for t, r in zip(terms, got)))
             for sl in (slice(0, 4), slice(4, 8))]
    for j, r in enumerate(got):
        assert torch.equal(torch.cat([p[j] for p in parts]), r)


@pytest.mark.parametrize("shape", [(8, 500), (1, 500), (8, 9, 500)])
def test_fixed_order_row_sums_match_sum_and_their_split(cuda, shape):
    """P2's row-sum mode (gric_score's sum over the matches) against
    .sum(-1) and the float64 sum (`p2_judge`), and split-invariant."""
    from rpe_tpu_torch.geometry import _products as prods

    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=shape).astype(np.float32)).to(cuda)
    got = prods.row_sum(x)
    assert p2_judge(got, x.sum(-1), x.double().sum(-1),
                    x.abs().double().sum(-1))[0]
    assert torch.equal(got, p2_serial(x))
    if shape[0] > 1:
        assert torch.equal(torch.cat([prods.row_sum(x[:4]),
                                      prods.row_sum(x[4:])]), got)


def test_orb_path_pose_is_independent_of_its_batch(cuda):
    """The ORB path at 8 pairs in one call, 4 + 4 and 1 x 8: R, t, valid,
    num_inliers and num_matches bit-equal."""
    frames, K, _ = make_sequence(9, 240, 480, seed=2)
    keys = torch.stack([rng.PRNGKey(i) for i in range(8)])
    fields = ("R", "t", "valid", "num_inliers", "num_matches")
    whole = estimate_sequence_batched(frames, K, keys, SMALL)
    assert bool(whole["valid"].all())
    for size in (4, 1):
        parts = [estimate_sequence_batched(frames[a:a + size + 1], K,
                                           keys[a:a + size], SMALL)
                 for a in range(0, 8, size)]
        for k in fields:
            assert torch.equal(torch.cat([q[k] for q in parts]), whole[k]), \
                (size, k)


def _sift_inputs(cuda, f, q, py, px, seed=0):
    """Random patch gradients and keypoints in the ranges SIFT gives P3 and
    P4 (the keypoint inside the patch, scales of octave coordinates), on
    the card; pidx picks each slot's patch, some twice."""
    from rpe_tpu_torch.ops import sift

    g = np.random.default_rng(seed + q + py)
    patches = torch.from_numpy(g.uniform(0, 1, (f, q, py, px))
                               .astype(np.float32)).to(cuda)
    gxp, gyp = sift._patch_grads(patches)

    def u(lo, hi):
        return torch.from_numpy(g.uniform(lo, hi, (f, q))
                                .astype(np.float32)).to(cuda)

    ucx, ucy = u(2, px - 3), u(2, py - 3)
    pidx = torch.from_numpy(g.integers(0, q, (f, q))).to(cuda)
    return gxp, gyp, ucx, ucy, u(1.6, 5.0), u(-3.14, 3.14), pidx


SIFT_SLOTS = [1, 31, 512, 3024]
SIFT_PATCHES = [(80, 80), (47, 80)]


@pytest.mark.parametrize("py,px", SIFT_PATCHES)
@pytest.mark.parametrize("q", SIFT_SLOTS)
def test_sift_orientation_hist_kernel_matches_plain_and_its_split(
        cuda, q, py, px):
    """P3 (csrc/sift_sample.cu) in one launch, held as chip_smoke.py holds
    it (tests/torch_judges.py `p3_judge`: within 1e-6 of the bins'
    magnitudes of the plain version and of a float64 run, at most one
    slot per 1000 with a sample in another bin than the plain's), and the
    same bits with its frames and its slots split in two."""
    from rpe_tpu_torch.ops import sift

    a = _sift_inputs(cuda, 2, q, py, px)[:5]
    n0 = kernels.LAUNCHES["sift_orientation_hist"]
    hist = sift.orientation_hist(*a)
    assert kernels.LAUNCHES["sift_orientation_hist"] == n0 + 1
    got, vx, vy, bins = sift.orientation_hist(*a, detail=True)
    assert torch.equal(got, hist) and hist.shape == (2, q, 36)
    ok, info = p3_judge(got, bins, p3_references(*a))
    assert ok, info
    assert torch.equal(torch.cat([sift.orientation_hist(*(x[:1] for x in a)),
                                  sift.orientation_hist(*(x[1:] for x in a))]),
                       hist)
    if q > 1:
        h = q // 2
        assert torch.equal(torch.cat([
            sift.orientation_hist(*(x[:, :h] for x in a)),
            sift.orientation_hist(*(x[:, h:] for x in a))], 1), hist)


# the main path's octaves at 1241x376: slots a frame (27216, 6912, 1728,
# 432 and 288 over 9 frames) and patch sizes
SIFT_OCTAVES = [(3024, 80, 80), (768, 80, 80), (192, 80, 80), (48, 80, 80),
                (32, 47, 80)]


@pytest.mark.parametrize("q,py,px", SIFT_OCTAVES)
def test_sift_orientation_hist_kernel_is_its_serial_reference(cuda, q, py,
                                                              px):
    """P3's histogram bit-equal to tests/torch_judges.py `p3_serial` of its
    own detail outputs (each bin's float32 terms summed in float64 in
    ascending sample order, rounded once) at the main path's octave shapes,
    with a slot whose gradient is one direction everywhere (every sample
    in one bin: the longest walk), a flat slot (every term +0.0, so none
    takes a place) and a slot whose gradient lies only in the window's
    zero ring (non-zero samples, every term +0.0); and bit-equal to
    itself with its slots split in three."""
    from rpe_tpu_torch.ops import sift

    a = list(_sift_inputs(cuda, 2, q, py, px, seed=7)[:5])
    ys, xs = torch.meshgrid(torch.arange(py, dtype=torch.float32),
                            torch.arange(px, dtype=torch.float32),
                            indexing="ij")
    gx, gy = sift._patch_grads((0.3 * xs - 0.7 * ys)[None].to(cuda))
    a[0], a[1] = a[0].clone(), a[1].clone()
    a[0][0, 0], a[1][0, 0] = gx[0], gy[0]          # one direction
    if q > 1:
        a[0][0, 1], a[1][0, 1] = 0.0, 0.0          # flat
    if q > 2:
        # radius 18 px about the centre, a gradient only beyond 20 px: the
        # samples inside the window's circle are 0, those with a gradient
        # lie in its zero ring, so every term is +0.0
        r = torch.sqrt((xs - px // 2) ** 2 + (ys - py // 2) ** 2)
        gx, gy = sift._patch_grads((r - 20.0).clamp_min(0.0)[None].to(cuda))
        a[0][0, 2], a[1][0, 2] = gx[0], gy[0]
        for i, v in ((2, px // 2), (3, py // 2), (4, 4.0)):
            a[i] = a[i].clone()
            a[i][0, 2] = v
    hist, vx, vy, bins = sift.orientation_hist(*a, detail=True)
    got, want = hist.view(torch.int32), p3_serial(vx, vy, bins)
    assert torch.equal(got, want.view(torch.int32))
    assert bool((bins[0, 0] == bins[0, 0, 0]).all())
    assert int((hist[0, 0] > 0).sum()) == 1
    if q > 1:
        assert bool((hist[0, 1] == 0).all())
    if q > 2:
        assert bool((hist[0, 2] == 0).all())
        assert bool(((vx[0, 2] != 0) | (vy[0, 2] != 0)).any())
    thirds = [0, q // 3, 2 * q // 3, q]
    parts = [sift.orientation_hist(*(x[:, s:e] for x in a))
             for s, e in zip(thirds[:-1], thirds[1:]) if e > s]
    assert torch.equal(torch.cat(parts, 1), hist)


@pytest.mark.parametrize("py,px", SIFT_PATCHES)
@pytest.mark.parametrize("q", SIFT_SLOTS)
def test_sift_descriptor_kernel_matches_plain_and_its_split(cuda, q, py, px):
    """P4 in one launch, held as chip_smoke.py holds it (`p4_judge`: within
    1e-5 of the plain version and of its float64 run on every slot), and
    the same bits with its frames and its slots split in two."""
    from rpe_tpu_torch.ops import sift

    gxp, gyp, ucx, ucy, scl, theta, pidx = _sift_inputs(cuda, 2, q, py, px)
    d = (gxp, gyp, pidx, ucx, ucy, scl, theta)
    n0 = kernels.LAUNCHES["sift_descriptor"]
    desc = sift.descriptor(*d)
    assert kernels.LAUNCHES["sift_descriptor"] == n0 + 1
    assert desc.shape == (2, q, 128)
    assert torch.equal(sift.descriptor(*d, detail=True)[0], desc)
    plain = sift.descriptor_plain(sift._take(gxp, pidx), sift._take(gyp, pidx),
                                  ucx, ucy, scl, theta)
    f64 = sift.descriptor_plain(
        sift._take(gxp.double(), pidx), sift._take(gyp.double(), pidx),
        ucx.double(), ucy.double(), scl.double(), theta.double())
    assert p4_judge(desc, plain, f64)[0]
    assert torch.equal(torch.cat([sift.descriptor(*(x[:1] for x in d)),
                                  sift.descriptor(*(x[1:] for x in d))]), desc)
    if q > 1:
        h = q // 2
        assert torch.equal(torch.cat([
            sift.descriptor(gxp, gyp, *(x[:, :h] for x in d[2:])),
            sift.descriptor(gxp, gyp, *(x[:, h:] for x in d[2:]))], 1), desc)


def test_sift_path_pose_is_independent_of_its_batch(cuda):
    """The SIFT A path at 4 pairs in one call, 2 + 2 and 1 x 4: R, t,
    valid, num_inliers and num_matches bit-equal."""
    frames, K, _ = make_sequence(5, 240, 480, seed=2)
    keys = torch.stack([rng.PRNGKey(i) for i in range(4)])
    fields = ("R", "t", "valid", "num_inliers", "num_matches")
    whole = estimate_sequence_batched(frames, K, keys, SIFT_A)
    assert bool(whole["valid"].all())
    for size in (2, 1):
        parts = [estimate_sequence_batched(frames[a:a + size + 1], K,
                                           keys[a:a + size], SIFT_A)
                 for a in range(0, 4, size)]
        for k in fields:
            assert torch.equal(torch.cat([q[k] for q in parts]), whole[k]), \
                (size, k)


def _reproduced(ref, got):
    """Share of ref's valid keypoints that reappear in got within 1e-3 px
    at the same octave and angle within 1e-3 rad, and the share of those
    with descriptor cosine >= 0.999 (one frame's numpy detections)."""
    vr, vt = ref["valid"], got["valid"]
    da = np.abs((ref["angle"][vr][:, None] - got["angle"][vt][None] + np.pi)
                % (2 * np.pi) - np.pi)
    near = ((np.abs(ref["xy"][vr][:, None] - got["xy"][vt][None]).max(-1)
             <= 1e-3) & (ref["level"][vr][:, None] == got["level"][vt][None])
            & (da <= 1e-3))
    found = near.any(1)
    j = near.argmax(1)
    cos = (ref["desc"][vr][found] * got["desc"][vt][j[found]]).sum(-1)
    return float(found.mean()), float((cos >= 0.999).mean())


@pytest.mark.parametrize("option", [{"upscale_first": False},
                                    {"select": "block2"},
                                    {"select": "approx"}],
                         ids=["no_upscale", "block2", "approx"])
def test_sift_options_run_on_the_card(scene, cuda, option):
    """The reference's options of `sift_detect_and_describe` on the card:
    P3 and P4 once per octave, and the detections of the CPU run
    reproduced (>= 98% of its keypoints within 1e-3 px, >= 98% of those
    with descriptor cosine >= 0.999)."""
    from rpe_tpu_torch.ops import sift

    frames = torch.from_numpy(scene[0][:2])
    cfg = SiftConfig(max_kpts=1024)
    kernels.reset_launches()
    got = sift.sift_detect_and_describe(frames.to(cuda), cfg, **option)
    want = kernels.sift_launches(240, 480, cfg, 1,
                                 option.get("upscale_first", True))
    assert {k: n for k, n in kernels.LAUNCHES.items() if n} == want
    cpu = sift.sift_detect_and_describe(frames, cfg, **option)
    for i in range(2):
        ref = {k: v[i].numpy() for k, v in cpu.items()}
        assert ref["valid"].sum() > 100
        found, close = _reproduced(ref, {k: v[i].cpu().numpy()
                                         for k, v in got.items()})
        assert found >= 0.98 and close >= 0.98, (i, found, close)


# P5-P8 (csrc/small_solvers.cu): a thread per problem, every output bit that
# of the plain version run eagerly on the card (a NaN where it has a NaN)

SMALL_BATCHES = [(32, 1), (32, 8), (32, 16), (32, 64), (32, 2560)]


def _spd(cuda, batch, n, seed):
    """Symmetric positive semi-definite float32 (*batch, n, n): M^T M of
    (n + 3) x n Gaussian rows with scales spread over decades."""
    g = np.random.default_rng(seed)
    m = g.normal(size=(*batch, n + 3, n)) * np.exp(g.normal(
        size=(*batch, 1, 1)) * 2.0)
    m = torch.from_numpy(m.astype(np.float32)).to(cuda)
    return m.transpose(-1, -2) @ m


def _degenerate(cuda, n, seed=5):
    """n x n matrices a solver must survive: zero, the identity, rank 1,
    repeated eigenvalues, a NaN and an infinity."""
    g = np.random.default_rng(seed)
    v = torch.from_numpy(g.normal(size=n).astype(np.float32)).to(cuda)
    rep = torch.ones(n, device=cuda)
    rep[-1] = 0.25
    nan = torch.eye(n, device=cuda)
    nan[0, 1] = nan[1, 0] = float("nan")
    inf = torch.eye(n, device=cuda)
    inf[-1, -1] = float("inf")
    return torch.stack([torch.zeros(n, n, device=cuda), torch.eye(
        n, device=cuda), v[:, None] * v[None], torch.diag(rep),
        2.0 * torch.eye(n, device=cuda) + v[:, None] * v[None], nan, inf])


def _launched(name, fn):
    """fn()'s result, after asserting it made one launch of `name` and no
    other."""
    torch.cuda.synchronize()
    kernels.reset_launches()
    out = fn()
    assert {k: n for k, n in kernels.LAUNCHES.items() if n} == {name: 1}
    return out


def _assert_same(got, want):
    for a, b in zip(got, want):
        assert same_bits(a, b), (a.shape, a.dtype)


@pytest.mark.parametrize("batch", SMALL_BATCHES + ["degenerate"])
@pytest.mark.parametrize("n,iters", [(9, 3), (10, 4), (9, 1)])
def test_smallest_eigvec_kernel_is_its_plain_version(cuda, n, iters, batch):
    """P5 at n = 9 (the normal matrices) and n = 10 with 4 rounds (K4's
    plain version): one launch, the plain version's bits, and the same
    bits with the batch split in two."""
    from rpe_tpu_torch.geometry import eig

    A = _degenerate(cuda, n) if batch == "degenerate" else _spd(
        cuda, batch, n, seed=n * batch[1])
    got = _launched("smallest_eigvec_sym",
                    lambda: eig.smallest_eigvec_sym(A, iters))
    _assert_same([got], [eig.smallest_eigvec_sym_plain(A, iters)])
    h = A.shape[0] // 2
    _assert_same([torch.cat([eig.smallest_eigvec_sym(A[:h], iters),
                             eig.smallest_eigvec_sym(A[h:], iters)])], [got])


@pytest.mark.parametrize("batch", SMALL_BATCHES + ["degenerate", "frame"])
def test_eigh3x3_kernel_is_its_plain_version(cuda, batch):
    """P6: one launch, the plain version's eigenvalues and vectors bit for
    bit (on E^T E of Gaussian E too), and the same with the batch split."""
    from rpe_tpu_torch.geometry import eig

    if batch == "frame":
        E = _spd(cuda, (32, 2560), 3, seed=1)[..., :3, :3] - 1.0
        A = E.transpose(-1, -2) @ E
    else:
        A = _degenerate(cuda, 3) if batch == "degenerate" else _spd(
            cuda, batch, 3, seed=batch[1])
    got = _launched("eigh3x3_desc", lambda: eig.eigh3x3_desc(A))
    _assert_same(got, eig.eigh3x3_desc_plain(A))
    h = A.shape[0] // 2
    parts = [eig.eigh3x3_desc(A[:h]), eig.eigh3x3_desc(A[h:])]
    _assert_same([torch.cat(x) for x in zip(*parts)], got)


def _essentials(cuda, batch, seed):
    g = np.random.default_rng(seed)
    E = torch.from_numpy(g.normal(size=(*batch, 3, 3)).astype(
        np.float32)).to(cuda)
    if batch[-1] >= 8:
        E[:, 0] = 0.0                                    # zero
        E[:, 1] = E[:, 2, :, :1] * E[:, 2, :1, :]        # rank 1
        E[:, 3, 0, 0] = float("nan")
        E[:, 4, 1, 2] = float("inf")
        E[:, 5] = torch.eye(3, device=cuda)              # repeated
    return E


@pytest.mark.parametrize("batch", SMALL_BATCHES)
def test_essential_frame_kernel_is_its_plain_version(cuda, batch):
    """P7 after P2 and P6 (`essential_frame` on the card): one launch of
    each per call, U and Vt the plain version's bits and strides (Vt a
    transposed view), also on zero, rank-1, non-finite and repeated E,
    and the same bits with the batch split in two."""
    from rpe_tpu_torch.geometry import epipolar

    E = _essentials(cuda, batch, seed=batch[-1])
    torch.cuda.synchronize()
    kernels.reset_launches()
    U, Vt = epipolar.essential_frame(E)
    assert {k: n for k, n in kernels.LAUNCHES.items() if n} == {
        "fixed_order_bmm": 2, "eigh3x3_desc": 1, "essential_frame": 1}
    with plain_small_solvers():
        Up, Vtp = epipolar.essential_frame(E)
    _assert_same((U, Vt), (Up, Vtp))
    assert U.stride() == Up.stride() and Vt.stride() == Vtp.stride()
    h = E.shape[0] // 2
    parts = [epipolar.essential_frame(E[:h]), epipolar.essential_frame(E[h:])]
    _assert_same([torch.cat(x) for x in zip(*parts)], (U, Vt))


@pytest.mark.parametrize("shape", [(256, 5), (1,), (2,), (2560, 1)])
def test_threefry_kernel_is_its_plain_version(cuda, shape):
    """P8 over the broadcast of 32 keys and a draw's counters (the hash of
    `split`, `uniform`, `randint`), over `fold_in`'s and over keys and
    counters past 32 bits: one launch, the plain version's words."""
    g = np.random.default_rng(len(shape) + shape[0])
    keys = torch.from_numpy(g.integers(0, 2 ** 32, (32, 2))).to(cuda)
    lo = torch.arange(int(np.prod(shape)), device=cuda).reshape(shape)
    k1 = keys[:, 0].reshape(32, *([1] * len(shape)))
    k2 = keys[:, 1].reshape(32, *([1] * len(shape)))
    args = (k1, k2, torch.zeros_like(lo), lo)
    got = _launched("threefry2x32", lambda: rng.threefry2x32(*args))
    assert got[0].shape == (32, *shape)
    _assert_same(got, rng.threefry2x32_plain(*args))
    d = torch.full((32,), 7, device=cuda)
    args = (keys[:, 0], keys[:, 1], torch.zeros_like(d), d)
    _assert_same(rng.threefry2x32(*args), rng.threefry2x32_plain(*args))
    wide = torch.from_numpy(g.integers(-2 ** 62, 2 ** 62, (4, 32))).to(cuda)
    _assert_same(rng.threefry2x32(*wide), rng.threefry2x32_plain(*wide))


PLAIN_PATHS = {
    "5pt": SMALL,
    "lo": dataclasses.replace(SMALL, ransac=dataclasses.replace(
        SMALL.ransac, lo=True)),
    "8pt": dataclasses.replace(SMALL, ransac=dataclasses.replace(
        SMALL.ransac, solver="8pt")),
    "sift_a": SIFT_A,
}


@pytest.mark.parametrize("path", list(PLAIN_PATHS))
def test_small_solvers_leave_every_path_bit_equal(scene, cuda, path):
    """The estimator with P5-P8 and with their plain versions (the eager
    chains) on the card: R, t, valid, num_inliers and num_matches bit for
    bit, at the path's launch counts."""
    frames, K, _, _ = scene
    cfg = PLAIN_PATHS[path]
    keys = torch.stack([rng.PRNGKey(2 ** 31 + i) for i in range(2)])
    kernels.reset_launches()
    out = estimate_sequence_batched(frames, K, keys, cfg)
    small = kernels.geometry_launches(1, path if path != "sift_a" else "5pt")
    assert {k: kernels.LAUNCHES[k] for k in SMALL_SOLVERS} == {
        k: small[k] for k in SMALL_SOLVERS}
    with plain_small_solvers():
        kernels.reset_launches()
        plain = estimate_sequence_batched(frames, K, keys, cfg)
        assert not any(kernels.LAUNCHES[k] for k in SMALL_SOLVERS)
    for k in ("R", "t", "valid", "num_inliers", "num_matches"):
        assert torch.equal(out[k], plain[k]), k
