"""A pair's pose does not depend on the batch it is estimated in.

On the CPU the port's path is batch-invariant as it stands; on the card
the geometry's batched products and sums go through P1
(csrc/five_point_coeffs.cu) and P2 (csrc/fixed_order.cu), whose order is
fixed by their code. These CPU tests hold:

- `estimate_sequence_batched` on tests/test_torch_parallel.py's small
  scene: R, t, `valid`, `num_inliers` and `num_matches` bit-equal for 8
  pairs in one call, 4 + 4 and 1 x 8;
- P1's wrapper on CPU tensors is `constraint_coeffs_plain` bit for bit,
  which matches rpe_tpu's `_build_constraint_coeffs`; the tables
  hard-coded in P1's source are `_mul_tables()`;
- P2's helpers on CPU tensors are today's expressions bit for bit at each
  call site's shapes (the grouped and chained `matmuls` too), within 1e-6
  of sum |a| |b| of a float64 product, and are called as often per
  estimator call as ops/kernels.py states; P2's serial float64 reference
  (tests/torch_judges.py `p2_serial`) is the exact product on integers;
- scripts/batch_invariance_probe.py's stage comparisons report 0.0, its
  SIFT detection sub-stages and its 8-point solver's stages too;
- the SIFT A path (120x400 frames, 512 slots): detections and R, t,
  `valid`, `num_inliers` bit-equal for 4 pairs in one call, 2 + 2 and
  1 x 4; P3's and P4's wrappers on CPU tensors are
  `orientation_hist_plain` and `descriptor_plain` bit for bit, detail
  outputs included; `kernels.sift_launches` counts the octaves that
  `scale_space` builds; with eight CPU threads SIFT's detections at 1
  pair a call equal those of one call of 4.

The kernels themselves are held to these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import importlib
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpe_tpu.geometry import five_point as jfp
from rpe_tpu.geometry.epipolar import _build_epipolar_rows as j_rows
from rpe_tpu_torch import rng
from rpe_tpu_torch.config import EstimatorConfig, MatcherConfig, OrbConfig, \
    RansacConfig, SiftConfig
from rpe_tpu_torch.geometry import _products as prod
from rpe_tpu_torch.geometry import five_point as tfp
from rpe_tpu_torch.ops import sift as tsift
from rpe_tpu_torch.pipeline.estimator import detect_features, \
    estimate_sequence_batched
from torch_gates import default_extraction_gates  # noqa: F401
from torch_gates import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "rpe_tpu_torch" / "csrc"
H, W = 96, 128
K = np.array([[120.0, 0, 64], [0, 120.0, 48], [0, 0, 1]], np.float32)
# tests/test_torch_parallel.py's TINY configuration
TINY = EstimatorConfig(
    orb=OrbConfig(nfeatures=256, nlevels=2, max_kpts=256),
    matcher=MatcherConfig(max_matches=64),
    ransac=RansacConfig(num_hypotheses=128))


def _scene(n_pairs=8):
    """tests/test_torch_parallel.py's block texture, its two halves rolled
    at different speeds: frames (n_pairs + 1, H, W) and keys (n_pairs, 2)."""
    g = np.random.default_rng(0)
    base = g.uniform(0, 255, (H // 8, W // 8)).astype(np.float32)
    base = base.repeat(8, 0).repeat(8, 1)
    frames = []
    for i in range(n_pairs + 1):
        f = np.roll(base, 2 * i, axis=1)
        f[: H // 2] = np.roll(base[: H // 2], 5 * i, axis=1)
        frames.append(f)
    keys = torch.stack([rng.PRNGKey(i) for i in range(n_pairs)])
    return torch.from_numpy(np.stack(frames)), keys


@pytest.fixture(scope="module")
def whole():
    imgs, keys = _scene()
    return imgs, keys, estimate_sequence_batched(imgs, K, keys, TINY,
                                                 device="cpu")


@pytest.mark.parametrize("size", [4, 2, 1])
def test_sequence_pose_bit_equal_across_splits(whole, size):
    imgs, keys, out = whole
    parts = [estimate_sequence_batched(imgs[a:a + size + 1], K,
                                       keys[a:a + size], TINY, device="cpu")
             for a in range(0, keys.shape[0], size)]
    assert out["valid"].sum() >= 7
    for k in ("R", "t", "valid", "num_inliers", "num_matches"):
        assert torch.equal(out[k], torch.cat([p[k] for p in parts])), k


def _minimal_problems(seed, b, noise=1e-3):
    """b noisy minimal problems: (b, 5, 2) normalized point pairs."""
    from rpe_tpu_torch.utils.synthetic import rotation_from_axis_angle

    g = np.random.default_rng(seed)
    p1s, p2s = [], []
    for _ in range(b):
        w = g.normal(size=3)
        R = rotation_from_axis_angle(
            w / np.linalg.norm(w) * np.deg2rad(g.uniform(2, 30)))
        t = g.normal(size=3)
        X = g.uniform([-2, -2, 3], [2, 2, 10], size=(5, 3))
        X2 = X @ R.T + t / np.linalg.norm(t)
        p1s.append((X / X[:, 2:3])[:, :2] + noise * g.normal(size=(5, 2)))
        p2s.append((X2 / X2[:, 2:3])[:, :2] + noise * g.normal(size=(5, 2)))
    return (np.stack(p1s).astype(np.float32), np.stack(p2s).astype(np.float32))


def test_constraint_coeffs_wrapper_is_plain_on_cpu():
    p1, p2 = _minimal_problems(3, 64)
    t1, t2 = torch.from_numpy(p1), torch.from_numpy(p2)
    n_w, c_w = tfp.constraint_coeffs(t1, t2)
    n_p, c_p = tfp.constraint_coeffs_plain(t1, t2)
    assert torch.equal(n_w, n_p) and torch.equal(c_w, c_p)
    # the plain version against the reference's
    A = j_rows(jnp.asarray(p1), jnp.asarray(p2))
    n_j = jfp._householder_null4(A)
    c_j = jfp._build_constraint_coeffs(n_j)
    c_j = c_j / jnp.sqrt(jnp.sum(c_j * c_j, -1, keepdims=True) + 1e-20)
    np.testing.assert_allclose(n_p.numpy(), np.asarray(n_j), atol=1e-5)
    np.testing.assert_allclose(c_p.numpy(), np.asarray(c_j), atol=2e-5)
    # batch shape (pairs, hypotheses) as the RANSAC calls it
    n_b, c_b = tfp.constraint_coeffs(t1.reshape(4, 16, 5, 2),
                                     t2.reshape(4, 16, 5, 2))
    assert n_b.shape == (4, 16, 9, 4) and c_b.shape == (4, 16, 10, 20)
    assert torch.equal(c_b.reshape(64, 10, 20), c_p)


def _cu_table(src, name):
    """The literal of table macro `name` (`#define T1_A {...}`)."""
    m = re.search(r"#define " + name + r" \{([^}]*)\}", src)
    return np.array([int(v) for v in
                     m.group(1).replace("\\", " ").split(",")])


@pytest.mark.parametrize("table", ["T1", "T2"])
def test_p1_tables_are_the_multiplication_tables(table):
    """The monomial tables hard-coded in csrc/five_point_coeffs.cu are
    `_mul_tables()` (the kernel also checks this when its library loads,
    on the card)."""
    src = (CSRC / "five_point_coeffs.cu").read_text()
    n_out, n_terms = (10, 2) if table == "T1" else (20, 3)
    rows_a = _cu_table(src, table + "_A").reshape(n_out, n_terms)
    rows_b = _cu_table(src, table + "_B").reshape(n_out, n_terms)
    want = tfp._mul_tables()[0 if table == "T1" else 1]
    dense = np.zeros(want.shape, np.int32).reshape(-1, 4, n_out)
    for m, (a, b) in enumerate(zip(rows_a, rows_b)):
        for p in range(n_terms):
            if a[p] >= 0:
                dense[a[p], b[p], m] = 1
    np.testing.assert_array_equal(dense.reshape(want.shape), want)


# (a shape, b shape) of each call site of geometry/_products.py `matmul`
MATMUL_SITES = {
    "normal_matrix 8-point refit": ((8, 9, 64), (8, 64, 9)),
    "normal_matrix ambiguity": ((8, 16, 9, 64), (8, 16, 64, 9)),
    "normal_matrix DLT samples": ((8, 64, 9, 8), (8, 64, 8, 9)),
    "project EtE": ((8, 1280, 3, 3), (8, 1280, 3, 3)),
    "project E v": ((8, 1280, 3, 3), (8, 1280, 3, 1)),
    "project U D Vt": ((8, 3, 3), (8, 3, 3)),
    "triangulate x2 R": ((8, 1, 64, 3), (8, 4, 3, 3)),
    "triangulate t R": ((8, 16, 4, 1, 3), (8, 16, 4, 3, 3)),
    "parallax x H^T": ((8, 64, 1, 3), (8, 1, 3, 3)),
    "parallax [e]x H": ((8, 64, 3, 3), (8, 1, 3, 3)),
}


def _operands(sa, sb, seed=0):
    g = np.random.default_rng(seed)
    a = torch.from_numpy(g.normal(size=sa).astype(np.float32))
    b = torch.from_numpy(g.normal(size=sb).astype(np.float32))
    if sa[-2] == 9 and sa[-1] == sb[-2] and sa[:-2] == sb[:-2]:
        # A^T as the sites pass it: a transposed view of the rows
        a = b.transpose(-1, -2)
    return a, b


@pytest.mark.parametrize("site", sorted(MATMUL_SITES))
def test_products_are_todays_expressions_on_cpu(site):
    a, b = _operands(*MATMUL_SITES[site])
    got = prod.matmul(a, b)
    assert torch.equal(got, torch.matmul(a, b))
    exact = torch.matmul(a.double(), b.double())
    scale = torch.matmul(a.abs().double(), b.abs().double())
    assert float(((got.double() - exact).abs() / scale).max()) <= 1e-6


# the terms of each call site of geometry/_products.py `matmuls`: (a, b)
# shapes for a @ b, (a, a2, b) for a @ (a2 @ b)
GROUP_SITES = {
    "project E v0, E v1": (((8, 1280, 3, 3), (8, 1280, 3, 1)),
                           ((8, 1280, 3, 3), (8, 1280, 3, 1))),
    "project U (D Vt)": (((8, 1280, 3, 3), (8, 1280, 3, 3),
                          (8, 1280, 3, 3)),),
    "decompose U (W Vt), U (W^T Vt)": (((8, 16, 3, 3), (3, 3),
                                        (8, 16, 3, 3)),
                                       ((8, 16, 3, 3), (3, 3),
                                        (8, 16, 3, 3))),
    "triangulate x2 R, t R": (((8, 1, 64, 3), (8, 4, 3, 3)),
                              ((8, 4, 1, 3), (8, 4, 3, 3))),
    "parallax xa H^T, xb H^T": (((8, 64, 1, 3), (8, 1, 3, 3)),
                                ((8, 64, 1, 3), (8, 1, 3, 3))),
}


@pytest.mark.parametrize("site", sorted(GROUP_SITES))
def test_grouped_products_are_todays_expressions_on_cpu(site):
    """`matmuls` on CPU tensors is the separate torch.matmul expressions
    bit for bit (a chain a @ (a2 @ b) too), each within 1e-6 of sum
    |a| |b| of a float64 product of its operands."""
    g = np.random.default_rng(len(site))
    terms = [tuple(torch.from_numpy(g.normal(size=s).astype(np.float32))
                   for s in t) for t in GROUP_SITES[site]]
    got = prod.matmuls(*terms)
    assert len(got) == len(terms)
    for t, r in zip(terms, got):
        a, b = t[0], torch.matmul(t[1], t[2]) if len(t) == 3 else t[1]
        assert torch.equal(r, torch.matmul(a, b))
        exact = torch.matmul(a.double(), b.double())
        scale = torch.matmul(a.abs().double(), b.abs().double())
        assert float(((r.double() - exact).abs() / scale).max()) <= 1e-6


@pytest.mark.parametrize("shapes", [((8, 9, 64), (8, 64, 9)),
                                    ((3, 3), (8, 16, 3, 3)),
                                    ((8, 1, 50, 3), (8, 4, 3, 3)),
                                    ((8, 64), None)])
def test_p2_serial_reference_is_the_exact_product(shapes):
    """tests/torch_judges.py `p2_serial` (the reference chip_smoke.py and
    the card tests hold every P2 launch to bit for bit) equals
    torch.matmul, or .sum(-1), in float64 on integer-valued inputs, whose
    sums are exact in any order; a chain equals the two products."""
    from torch_judges import p2_serial

    g = np.random.default_rng(7)
    sa, sb = shapes
    a = torch.from_numpy(g.integers(-64, 65, sa).astype(np.float32))
    if sb is None:
        want = a.double().sum(-1)
        assert torch.equal(p2_serial(a).double(), want)
        return
    b = torch.from_numpy(g.integers(-64, 65, sb).astype(np.float32))
    got = p2_serial(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got.double(), torch.matmul(a.double(), b.double()))
    if sa[-1] == sa[-2]:
        c = p2_serial(a, b, a2=a)
        assert torch.equal(c, p2_serial(a, p2_serial(a, b)))
        assert torch.equal(c.double(), torch.matmul(
            a.double(), torch.matmul(a.double(), b.double())))


@pytest.mark.parametrize("shape", [(8, 64), (1, 64), (8, 9, 64)])
def test_row_sum_is_todays_sum_on_cpu(shape):
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=shape).astype(np.float32))
    got = prod.row_sum(x)
    assert torch.equal(got, x.sum(-1))
    exact = x.double().sum(-1)
    assert float(((got.double() - exact).abs()
                  / x.abs().double().sum(-1)).max()) <= 1e-6


def _probe():
    spec = importlib.util.spec_from_file_location(
        "batch_invariance_probe",
        ROOT / "scripts" / "batch_invariance_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    return probe


def test_probe_stages_report_zero_on_cpu():
    probe = _probe()
    imgs, keys = _scene()
    res = probe.run_probe(imgs, torch.from_numpy(K), keys, TINY, sizes=(4, 1),
                          say=lambda _: None)
    assert "pose" in res and "coeffs" in res and "triangulate" in res
    moved = {k: v for k, v in res.items() if any(x != 0.0 for x in v.values())}
    assert not moved, moved


def test_probe_8pt_stages_report_zero_on_cpu():
    """The probe with the 8-point solver (`--solver 8pt`): its hypothesis
    stages in place of the 5-point ones, every stage 0."""
    probe = _probe()
    imgs, keys = _scene()
    cfg = EstimatorConfig(orb=TINY.orb, matcher=TINY.matcher,
                          ransac=RansacConfig(num_hypotheses=128,
                                              solver="8pt"))
    res = probe.run_probe(imgs, torch.from_numpy(K), keys, cfg, sizes=(4, 1),
                          say=lambda _: None)
    assert "hypotheses" in res and "8pt eig" in res and "coeffs" not in res
    moved = {k: v for k, v in res.items() if any(x != 0.0 for x in v.values())}
    assert not moved, moved


@pytest.mark.parametrize("path", ["orb", "lo", "8pt", "pairs_2d"])
def test_p2_launches_per_call(monkeypatch, path):
    """ops/kernels.py's P2 counts per estimator call (the launch gates of
    chip_smoke.py and tests/test_torch_gpu.py): the fixed-order helper
    calls of the ORB path, of LO-RANSAC, of the 8-point solver and of
    `estimate_pairs_2d` on a (1, 2) mesh, counted on the CPU."""
    from rpe_tpu_torch.ops import kernels
    from rpe_tpu_torch.parallel.mesh import Mesh
    from rpe_tpu_torch.parallel.sharded_estimator import estimate_pairs_2d

    calls = [0]
    # the modules themselves (the package re-exports a function under the
    # name recover_pose)
    for mod in (importlib.import_module(f"rpe_tpu_torch.geometry.{m}")
                for m in ("epipolar", "homography", "recover_pose")):
        for name in ("matmul", "matmuls", "row_sum"):
            fn = getattr(mod, name, None)
            if fn is getattr(prod, name):
                def counted(*a, _fn=fn):
                    calls[0] += 1
                    return _fn(*a)
                monkeypatch.setattr(mod, name, counted)
    imgs, keys = _scene(2)
    if path == "pairs_2d":
        estimate_pairs_2d(imgs[:-1], imgs[1:], K, keys, TINY,
                          Mesh([["cpu", "cpu"]], ("pairs", "hyp")))
        assert calls[0] == kernels.P2_PAIRS_2D
        return
    lo = path == "lo"
    cfg = EstimatorConfig(orb=TINY.orb, matcher=TINY.matcher,
                          ransac=RansacConfig(num_hypotheses=128, lo=lo,
                                              solver=path if path == "8pt"
                                              else "5pt"))
    estimate_sequence_batched(imgs, K, keys, cfg, device="cpu")
    assert calls[0] == {"orb": kernels.P2_PER_CALL,
                        "lo": kernels.P2_PER_CALL_LO,
                        "8pt": kernels.P2_PER_CALL_8PT}[path]


@pytest.mark.parametrize("path", ["5pt", "lo", "8pt", "pairs_2d"])
def test_small_solver_launches_per_call(monkeypatch, path):
    """ops/kernels.py's P5-P8 counts per estimator call (the launch gates
    of chip_smoke.py and tests/test_torch_gpu.py): the calls of
    `smallest_eigvec_sym`, `eigh3x3_desc`, `frame_rotations` and
    `threefry2x32` on the ORB path, under LO-RANSAC, with the 8-point
    solver and in `estimate_pairs_2d` on a (1, 2) mesh, counted on the
    CPU. K4's plain version, which calls `smallest_eigvec_sym` on the CPU,
    is the kernel K4 on the card, so its calls are not counted."""
    from torch_judges import small_solvers_patched

    from rpe_tpu_torch.ops import kernels
    from rpe_tpu_torch.parallel.mesh import Mesh
    from rpe_tpu_torch.parallel.sharded_estimator import estimate_pairs_2d

    calls = {k: 0 for k in kernels.SMALL_SOLVERS_PER_CALL["5pt"]}
    k4 = [False]

    def wrap(name, fn):
        def counted(*a, **k):
            calls[name] += not k4[0]
            return fn(*a, **k)
        return counted

    plain_k4 = tfp.solve_roots_plain

    def k4_plain(*a):
        k4[0] = True
        try:
            return plain_k4(*a)
        finally:
            k4[0] = False

    monkeypatch.setattr(tfp, "solve_roots_plain", k4_plain)
    imgs, keys = _scene(2)
    with small_solvers_patched(wrap):
        if path == "pairs_2d":
            estimate_pairs_2d(imgs[:-1], imgs[1:], K, keys, TINY,
                              Mesh([["cpu", "cpu"]], ("pairs", "hyp")))
        else:
            cfg = EstimatorConfig(orb=TINY.orb, matcher=TINY.matcher,
                                  ransac=RansacConfig(
                                      num_hypotheses=128, lo=path == "lo",
                                      solver="8pt" if path == "8pt"
                                      else "5pt"))
            assert kernels.geometry_path(cfg.ransac) == path
            estimate_sequence_batched(imgs, K, keys, cfg, device="cpu")
    assert calls == (kernels.SMALL_SOLVERS_PAIRS_2D if path == "pairs_2d"
                     else kernels.SMALL_SOLVERS_PER_CALL[path])


# tests/test_torch_sift.py's size: 120x400 frames, 512 slots; its config A
# cut to size
SIFT_H, SIFT_W = 120, 400
SIFT_A = EstimatorConfig(
    feature_method="SIFT", sift=SiftConfig(max_kpts=512),
    matcher=MatcherConfig(norm_type="l2", max_matches=128),
    ransac=RansacConfig(num_hypotheses=64, degensac=False))


@pytest.fixture(scope="module")
def sift_scene():
    from rpe_tpu_torch.utils.synthetic import make_sequence

    frames, Ks, _ = make_sequence(5, SIFT_H, SIFT_W, seed=4)
    keys = torch.stack([rng.PRNGKey(i) for i in range(4)])
    imgs = torch.from_numpy(frames)
    return imgs, Ks, keys, estimate_sequence_batched(
        imgs, Ks, keys, SIFT_A, device="cpu"), detect_features(imgs, SIFT_A)


@pytest.mark.parametrize("size", [2, 1])
def test_sift_pose_and_detections_bit_equal_across_splits(sift_scene, size):
    imgs, Ks, keys, out, whole = sift_scene
    parts = [estimate_sequence_batched(imgs[a:a + size + 1], Ks,
                                       keys[a:a + size], SIFT_A,
                                       device="cpu")
             for a in range(0, 4, size)]
    assert out["valid"].sum() >= 3
    for k in ("R", "t", "valid", "num_inliers", "num_matches"):
        assert torch.equal(out[k], torch.cat([p[k] for p in parts])), k
    assert whole["valid"].sum() >= 300
    for a in range(0, 4, size):
        part = detect_features(imgs[a:a + size + 1], SIFT_A)
        for k in whole:
            assert torch.equal(whole[k][a:a + size + 1], part[k]), (a, k)


def test_sift_detections_bit_equal_across_splits_on_eight_threads():
    """With eight CPU threads an elementwise operation's split across
    threads, and so which elements take the scalar atan2 instead of the
    vectorised one, depended on the batch: SIFT's plain histogram and
    descriptor run frame by frame (ops/sift.py `_frame_by_frame`), so a
    frame's descriptors and detections are the same bits in one call of
    4 pairs and at 1 pair a call. The scene and configuration of
    `scripts/batch_invariance_probe.py --feature sift --pairs 4 --size
    120 400`, whose descriptor moved at octave 2."""
    from rpe_tpu_torch.utils.synthetic import make_sequence

    cfg = EstimatorConfig(feature_method="SIFT",
                          matcher=MatcherConfig(norm_type="l2"))
    frames, _, _ = make_sequence(5, SIFT_H, SIFT_W, seed=0,
                                 step=(0.035, -0.005, 0.1), rot_deg=0.25)
    imgs = torch.from_numpy(frames)
    n = torch.get_num_threads()
    torch.set_num_threads(8)
    try:
        whole = detect_features(imgs, cfg)
        parts = [detect_features(imgs[a:a + 2], cfg) for a in range(4)]
    finally:
        torch.set_num_threads(n)
    assert whole["valid"].sum() >= 1000
    for a, part in enumerate(parts):
        for k in whole:
            assert torch.equal(whole[k][a:a + 2], part[k]), (a, k)


def _sift_stage_inputs(seed=0, f=2, q=64, py=80, px=80):
    """Random patch gradients and keypoints in the ranges SIFT gives P3 and
    P4, on the CPU."""
    g = np.random.default_rng(seed)
    patches = torch.from_numpy(g.uniform(0, 1, (f, q, py, px))
                               .astype(np.float32))
    gxp, gyp = tsift._patch_grads(patches)

    def u(lo, hi):
        return torch.from_numpy(g.uniform(lo, hi, (f, q)).astype(np.float32))

    pidx = torch.from_numpy(g.integers(0, q, (f, q)))
    return gxp, gyp, u(20, 40), u(20, 40), u(1.6, 4.0), u(-3.1, 3.1), pidx


@pytest.mark.parametrize("shape", [(80, 80), (60, 80), (47, 80)])
def test_sift_wrappers_are_plain_on_cpu(shape):
    gxp, gyp, ucx, ucy, scl, theta, pidx = _sift_stage_inputs(0, 2, 64,
                                                              *shape)
    hist = tsift.orientation_hist(gxp, gyp, ucx, ucy, scl)
    assert torch.equal(hist, tsift.orientation_hist_plain(gxp, gyp, ucx, ucy,
                                                          scl))
    got = tsift.orientation_hist(gxp, gyp, ucx, ucy, scl, detail=True)
    want = tsift.orientation_hist_plain(gxp, gyp, ucx, ucy, scl, detail=True)
    assert got[0].shape == (2, 64, 36) and got[3].shape == (2, 64, 576)
    assert got[3].dtype == torch.uint8
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(got[0], hist)
    desc = tsift.descriptor(gxp, gyp, pidx, ucx, ucy, scl, theta)
    plain = tsift.descriptor_plain(tsift._take(gxp, pidx),
                                   tsift._take(gyp, pidx), ucx, ucy, scl,
                                   theta, detail=True)
    assert desc.shape == (2, 64, 128) and torch.equal(desc, plain[0])
    got = tsift.descriptor(gxp, gyp, pidx, ucx, ucy, scl, theta, detail=True)
    assert all(torch.equal(a, b) for a, b in zip(got, plain))


def test_probe_sift_substages_report_zero_on_cpu(sift_scene):
    probe = _probe()
    res = probe.sift_detection_probe(sift_scene[0][:3], SIFT_A, sizes=(1,),
                                     say=lambda _: None)
    assert set(res) == {"scale space", "extrema", "select", "refine",
                        "patches", "orient sample", "orient hist", "theta",
                        "reselect", "desc sample", "desc hist", "desc"}
    moved = {k: v for k, v in res.items() if any(x != 0.0 for x in v.values())}
    assert not moved, moved


@pytest.mark.parametrize("h,w,octaves", [(120, 400, 3), (376, 1241, 5),
                                         (240, 480, 4)])
def test_sift_launches_count_the_octaves_built(h, w, octaves):
    """ops/kernels.py `sift_launches` (the launch gates of chip_smoke.py
    and tests/test_torch_gpu.py): P3 and P4 once per octave that
    `scale_space` builds, here counted on frames of each size."""
    from rpe_tpu_torch.ops import kernels

    cfg = SiftConfig()
    built = tsift.scale_space(torch.zeros(1, h, w), cfg.noctaves)
    assert len(built) == octaves
    assert [tuple(g.shape[-2:]) for g in built] == tsift.octave_sizes(
        h, w, cfg.noctaves)
    assert kernels.sift_launches(h, w, cfg, calls=3) == {
        "sift_orientation_hist": 3 * octaves, "sift_descriptor": 3 * octaves}
