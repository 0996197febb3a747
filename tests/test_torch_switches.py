"""The reference's off-default switches in rpe_tpu_torch against rpe_tpu on
the CPU: OpenCV's BRIEF pattern (RPE_BRIEF=cv2) and quantised sampling
(RPE_BRIEF_QUANT), the per-level ORB path (RPE_NO_ATLAS, use_atlas=False)
with its pyramid, reflect-101 blur and detector, the unfused atlas
(RPE_NO_FUSED_ATLAS), LO-RANSAC, `unpack_descriptor_bits` and the
calibration tool. The same numpy arrays go to both packages.

The reference reads RPE_BRIEF and RPE_BRIEF_QUANT when it traces, and
caches `brief_bin_tables` on its bin count alone; the tests that flip them
clear that cache and the trace cache of its one jitted function that reads
them, `extract_windows_t_brief`, before and after (`_fresh_reference`), and
trace its ORB anew per call. The port reads them at call time."""

import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpe_tpu.geometry import epipolar as jepi
from rpe_tpu.geometry import ransac as jran
from rpe_tpu.ops import atlas as jatlas
from rpe_tpu.ops import extract_pallas as jext
from rpe_tpu.ops import fast as jfast
from rpe_tpu.ops import match as jmatch
from rpe_tpu.ops import orb as jorb
from rpe_tpu.ops import pyramid as jpyr
from rpe_tpu.tools import calibrate as jcal
from rpe_tpu_torch import convert
from rpe_tpu_torch.geometry import ransac as tran
from rpe_tpu_torch.ops import atlas as tatlas
from rpe_tpu_torch.ops import extract as textract
from rpe_tpu_torch.ops import fast as tfast
from rpe_tpu_torch.ops import match as tmatch
from rpe_tpu_torch.ops import orb as torb
from rpe_tpu_torch.ops import pyramid as tpyr
from rpe_tpu_torch.tools import calibrate as tcal
from rpe_tpu_torch.utils.synthetic import make_sequence
from torch_gates import default_extraction_gates  # noqa: F401
from torch_gates import one_torch_thread  # noqa: F401

H, W, NLEV = 188, 620, 4
KW = dict(nfeatures=256, nlevels=NLEV, max_kpts=256, extract_cap=72, band=32)
PATCH = 31
DATA = Path(__file__).parent / "data"


@pytest.fixture(scope="module")
def frames():
    return make_sequence(2, H, W, seed=5)[0]


@contextlib.contextmanager
def _fresh_reference():
    """The reference's caches that keep a pattern or a rounding, emptied
    before and after."""
    jorb.brief_bin_tables.cache_clear()
    jext.extract_windows_t_brief.clear_cache()
    try:
        yield
    finally:
        jorb.brief_bin_tables.cache_clear()
        jext.extract_windows_t_brief.clear_cache()


# ---- the pattern and the quant parse ----------------------------------------

def test_cv2_pattern_table_equal(monkeypatch):
    """The port's copy of OpenCV's table is the reference's, selected by
    RPE_BRIEF=cv2 only; it stays within +-13 per coordinate and reaches
    radius 18.38 (140 points past 13, 47 past 15)."""
    cv2 = torb.brief_pattern(kind="cv2")
    np.testing.assert_array_equal(cv2, jorb.brief_pattern(kind="cv2"))
    r = np.sqrt((cv2.astype(np.float64) ** 2).sum(-1))
    assert np.abs(cv2).max() == 13 and abs(r.max() - 18.3848) < 1e-4
    assert (r > 13).sum() == 140 and (r > 15).sum() == 47
    for value in ("cv2", "gauss", "CV2", ""):
        monkeypatch.setenv("RPE_BRIEF", value)
        np.testing.assert_array_equal(torb.brief_pattern(),
                                      jorb.brief_pattern())
        assert torb.brief_kind() == ("cv2" if value == "cv2" else "gauss")
    assert textract.pattern_reach2("cv2") == 338
    assert textract.pattern_reach2("gauss") <= torb.PATTERN_R ** 2


def _reference_quant():
    """Whether the reference's `_brief_bits` rounds under the current
    environment: 0.6 < 0.9 holds unrounded, 1 < 1 does not."""
    bit = jorb._brief_bits(jnp.asarray([[0.6, 0.9]], jnp.float32))
    return int(np.asarray(bit)[0, 0]) == 0


@pytest.mark.parametrize("brief", [None, "gauss", "cv2", "", "CV2"])
def test_quant_parse_matches_reference(monkeypatch, brief):
    """`brief_quant` over every RPE_BRIEF_QUANT value beside this RPE_BRIEF
    (unset: on iff RPE_BRIEF is "cv2"; "" and "0" off; anything else on),
    and an explicit `quant` over both."""
    if brief is None:
        monkeypatch.delenv("RPE_BRIEF", raising=False)
    else:
        monkeypatch.setenv("RPE_BRIEF", brief)
    for q in (None, "", "0", "1", "yes", "false", "00", " 0", "off"):
        if q is None:
            monkeypatch.delenv("RPE_BRIEF_QUANT", raising=False)
        else:
            monkeypatch.setenv("RPE_BRIEF_QUANT", q)
        assert torb.brief_quant() == _reference_quant(), (brief, q)
        assert torb.brief_quant(True) and not torb.brief_quant(False)


# ---- sampling ---------------------------------------------------------------

@pytest.fixture(scope="module")
def patches():
    """Blurred patches on a half-integer grid (ties after rounding, values
    exactly at .5), their transposes, angles and raw moments."""
    g = np.random.default_rng(12)
    blur = (g.integers(0, 40, (400, PATCH, PATCH)) * 0.5).astype(np.float32)
    ang = g.uniform(-np.pi, np.pi, 400).astype(np.float32)
    m10 = g.normal(0, 300, 400).astype(np.float32)
    m01 = g.normal(0, 300, 400).astype(np.float32)
    return blur, ang, m10, m01


@pytest.mark.parametrize("kind,quant", [("cv2", True), ("cv2", False),
                                        ("gauss", True)])
def test_steered_brief_bit_equal(monkeypatch, patches, kind, quant):
    """steered_brief, steered_brief_t and steered_brief_t_binned with the
    pattern and rounding given explicitly, and read from the environment,
    are the reference's bit for bit."""
    blur, ang, m10, m01 = patches
    blur_t = np.ascontiguousarray(blur.transpose(0, 2, 1))
    monkeypatch.setenv("RPE_BRIEF", kind)
    monkeypatch.setenv("RPE_BRIEF_QUANT", "1" if quant else "0")
    with _fresh_reference():
        want = [np.asarray(f(*args, quant=quant)) for f, args in (
            (jorb.steered_brief, (jnp.asarray(blur), jnp.asarray(ang))),
            (jorb.steered_brief_t, (jnp.asarray(blur_t), jnp.asarray(ang))),
            (jorb.steered_brief_t_binned, (jnp.asarray(blur_t),
                                           jnp.asarray(m10),
                                           jnp.asarray(m01))))]
    tb, tt, ta, t10, t01 = (torch.from_numpy(a) for a in
                            (blur, blur_t, ang, m10, m01))
    for q, k in ((quant, kind), (None, None)):
        got = [torb.steered_brief(tb, ta, quant=q, kind=k),
               torb.steered_brief_t(tt, ta, quant=q, kind=k),
               torb.steered_brief_t_binned(tt, t10, t01, quant=q, kind=k)]
        for g_, w_, name in zip(got, want, ("k2", "transposed", "binned")):
            np.testing.assert_array_equal(g_.numpy(), w_, err_msg=name)
    assert (want[0] != np.asarray(jorb.steered_brief(
        jnp.asarray(blur), jnp.asarray(ang), quant=not quant))).any()


def test_bin_tables_keyed_by_pattern(monkeypatch):
    """brief_bin_tables follows the pattern it is asked for (the reference's
    cache keeps the first one it saw in a process)."""
    for kind in ("cv2", "gauss"):
        monkeypatch.setenv("RPE_BRIEF", kind)
        with _fresh_reference():
            ix_j, iy_j, _, _ = jorb.brief_bin_tables()
        for ix, iy in (torb.brief_bin_tables(), torb.brief_bin_tables(
                kind=kind)):
            np.testing.assert_array_equal(ix, ix_j)
            np.testing.assert_array_equal(iy, iy_j)
    assert not np.array_equal(torb.brief_bin_tables(kind="cv2")[0],
                              torb.brief_bin_tables(kind="gauss")[0])


# ---- K2's and K12's plain versions in the new modes -------------------------

@pytest.fixture(scope="module")
def slot_case(frames):
    """A fused atlas of frame 0 with its wrapped blur, and band tables of
    300 seeded keypoints (clustered rows, a tenth invalid), from the
    reference's `banded_extract` (XLA patches)."""
    a_j, _ = jatlas.build_atlas_fused(jnp.asarray(frames[0]), NLEV, 1.1)
    b_j = jatlas.gaussian_blur_rolled(a_j)
    a, b = np.array(a_j), np.array(b_j)
    ha, wp = a.shape
    g = np.random.default_rng(11)
    y = np.concatenate([g.integers(20, ha - 40, 220), g.integers(100, 104,
                                                                 80)])
    xy = np.stack([g.integers(16, wp - 16, 300), y], -1).astype(np.float32)
    valid = g.uniform(size=300) < 0.9
    ref = jatlas.banded_extract(a_j, b_j, jnp.asarray(xy),
                                jnp.asarray(valid), cap=72, band=32)
    return a, b, {k: np.asarray(v) for k, v in ref.items()
                  if k in ("tbl_x0", "rel_y", "patches_raw",
                           "patches_blur")}


@pytest.mark.parametrize("kind,quant", [("cv2", True), ("gauss", True),
                                        ("cv2", False)])
def test_extract_brief_plain_modes_match_reference(monkeypatch, slot_case,
                                                   kind, quant):
    """K2's and K12's plain versions with the pattern and rounding
    against the reference's on the same slots, as the K2 tests hold the
    default mode (tests/test_torch_detect.py): K2's bits >= 0.999 against
    `steered_brief` of the reference's XLA patches at its IC angles (the
    angle is computed in another order); K12's against the reference's
    binned twin at the moments of the reference's patches, the same (the
    moments sum in another order, which can move a slot across a bin
    edge); parked slots zero."""
    a, b, ref = slot_case
    monkeypatch.setenv("RPE_BRIEF", kind)
    raw, blur = ref["patches_raw"], ref["patches_blur"]
    mask, us, vs = jorb._ic_angle_masks()
    m10_x = np.asarray(jnp.sum(raw * (mask * us), axis=(1, 2)))
    m01_x = np.asarray(jnp.sum(raw * (mask * vs), axis=(1, 2)))
    with _fresh_reference():
        bits_j = np.asarray(jorb.steered_brief(
            jnp.asarray(blur), jorb.ic_angles(jnp.asarray(raw)),
            quant=quant))
        bin_j = np.asarray(jorb.steered_brief_t_binned(
            jnp.asarray(blur.transpose(0, 2, 1)), jnp.asarray(m10_x),
            jnp.asarray(m01_x), quant=quant))
    args = (torch.from_numpy(a[None]), torch.from_numpy(b[None]),
            torch.from_numpy(ref["tbl_x0"][None]),
            torch.from_numpy(ref["rel_y"][None]), 32)
    live = ref["rel_y"].reshape(-1) >= 0
    assert live.sum() > 200
    for binned, want in ((False, bits_j), (True, bin_j)):
        bits, m10, m01 = textract.extract_brief_plain(
            *args, binned=binned, quant=quant, kind=kind)
        same = bits[0].numpy()[live] == want[live]
        assert same.mean() >= 0.999, (binned, same.mean())
        assert not bits[0].numpy()[~live].any()
        # the wrapper's CPU route reads the same switches from the
        # environment
        monkeypatch.setenv("RPE_BRIEF_QUANT", "1" if quant else "0")
        env_bits = textract.extract_brief(*args, binned=binned)[0]
        assert torch.equal(env_bits, bits)
        monkeypatch.delenv("RPE_BRIEF_QUANT")
    np.testing.assert_allclose(m10[0].numpy(), m10_x, rtol=1e-4, atol=2.0)


def test_k12_plain_cv2_quant_matches_reference_kernel(monkeypatch,
                                                      slot_case):
    """K12's plain version in the cv2 + quant mode against the reference's
    binned Pallas kernel in that mode (interpret mode, one band per grid
    step): bits >= 0.999 on the live slots (the kernel's moments sum in
    another order, which can move a slot across a bin edge)."""
    a, b, ref = slot_case
    monkeypatch.setenv("RPE_BRIEF", "cv2")
    with _fresh_reference():
        bits_j, _, _ = jext.extract_windows_t_brief(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(ref["tbl_x0"]),
            jnp.asarray(ref["rel_y"]), interpret=True, band=32, nbody=1,
            binned=True, quant=True)
    bits_j = np.asarray(bits_j).reshape(-1, 256)
    bits, _, _ = textract.extract_brief(
        torch.from_numpy(a[None]), torch.from_numpy(b[None]),
        torch.from_numpy(ref["tbl_x0"][None]),
        torch.from_numpy(ref["rel_y"][None]), 32, binned=True)
    live = ref["rel_y"].reshape(-1) >= 0
    assert (bits[0].numpy()[live] == bits_j[live]).mean() >= 0.999
    assert not bits_j[~live].any()


# ---- pyramid, blur, atlas, per-level detection ------------------------------

def test_resize_weights_match_reference():
    """`resize_weights` against jax.image.resize of an identity (its
    effective weights) at the test frames' level shapes and at levels 1, 6
    and 11 of a KITTI frame: within 2e-6 (the compiled reference rounds a
    few sample positions and weight sums differently)."""
    for h, w, nl, lv in ((188, 620, 4, (1, 2, 3)), (376, 1241, 12,
                                                     (1, 6, 11))):
        shapes = tpyr.level_shapes(h, w, nl, 1.1)
        for lh, lw in (shapes[l] for l in lv):
            for n_in, n_out in ((h, lh), (w, lw)):
                want = np.asarray(jax.image.resize(
                    jnp.eye(n_in, dtype=jnp.float32), (n_in, n_out),
                    "linear"))
                got = tpyr.resize_weights(n_in, n_out)
                assert np.abs(got - want).max() <= 2e-6, (n_in, n_out)


def test_build_pyramid_and_blur_match_reference(frames):
    """build_pyramid within 1e-3 of the reference's levels on [0, 255]
    (weights within 2e-6, three taps a side); level 0 is the input.
    gaussian_blur (reflect-101) within 1e-4 on the same level images, and
    not the wrapped blur."""
    imgs = torch.from_numpy(frames)
    lv_t = tpyr.build_pyramid(imgs, NLEV, 1.1)
    assert lv_t[0] is imgs
    for i in range(len(frames)):
        lv_j = jpyr.build_pyramid(jnp.asarray(frames[i]), NLEV, 1.1)
        for l, (a, b) in enumerate(zip(lv_j, lv_t)):
            assert b.shape[1:] == a.shape
            np.testing.assert_allclose(b[i].numpy(), np.asarray(a), atol=1e-3,
                                       rtol=0, err_msg=f"level {l}")
    for lvl in lv_t:
        want = np.stack([np.asarray(jpyr.gaussian_blur(jnp.asarray(x)))
                         for x in lvl.numpy()])
        got = tpyr.gaussian_blur(lvl).numpy()
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
        wrapped = tatlas.gaussian_blur_rolled(lvl).numpy()
        assert np.abs(wrapped - want).max() > 1.0


def test_build_atlas_equal(frames):
    lv_t = tpyr.build_pyramid(torch.from_numpy(frames), NLEV, 1.1)
    atlas, layout = tatlas.build_atlas(lv_t, H, W, NLEV, 1.1)
    for i in range(len(frames)):
        a_j, layout_j = jatlas.build_atlas(
            [jnp.asarray(x[i].numpy()) for x in lv_t], H, W, NLEV, 1.1)
        assert layout == layout_j
        np.testing.assert_array_equal(atlas[i].numpy(), np.asarray(a_j))


_detect_level_j = jax.jit(jfast.detect_level, static_argnums=(1, 2, 3))


def test_detect_level_matches_reference(frames):
    """Per level of the same pyramid: xy and valid equal, Harris scores
    within rtol 1e-5 (box sums in another order); the 19 px margin covers
    the 4 px band where K1 wraps and its plain version pads."""
    lv_t = tpyr.build_pyramid(torch.from_numpy(frames), NLEV, 1.1)
    for lvl, quota in zip(lv_t, torb.level_quotas(256, NLEV, 1.1)):
        xy, score, valid = tfast.detect_level(lvl, 15.0, torb.EDGE_MARGIN,
                                              quota)
        assert xy.shape == (len(frames), quota, 2)
        for i in range(len(frames)):
            xy_j, s_j, v_j = (np.asarray(x) for x in _detect_level_j(
                jnp.asarray(lvl[i].numpy()), 15.0, torb.EDGE_MARGIN, quota))
            np.testing.assert_array_equal(xy[i].numpy(), xy_j)
            np.testing.assert_array_equal(valid[i].numpy(), v_j)
            assert v_j.sum() > quota // 2
            np.testing.assert_allclose(score[i].numpy()[v_j], s_j[v_j],
                                       rtol=1e-5)


# ---- ORB end to end ---------------------------------------------------------

ORB_CASES = {
    "use_atlas_false": ({}, dict(use_atlas=False), 1),
    "cv2": ({"RPE_BRIEF": "cv2"}, {}, 1),
    "cv2_v7": ({"RPE_BRIEF": "cv2", "RPE_EXTRACT_T_V7": "1"}, {}, 1),
}


@pytest.mark.parametrize("case", list(ORB_CASES))
def test_orb_switches_match_reference(monkeypatch, frames, case):
    """The port's `orb_detect_and_describe` under the switch against the
    reference's under the same switch (its Pallas extraction in interpret
    mode, one band per grid step): xy, level and valid equal, bits >=
    0.999, angles within 1e-3."""
    env, kw, n = ORB_CASES[case]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = torb.orb_detect_and_describe(torch.from_numpy(frames[:n]), **kw,
                                       **KW)
    monkeypatch.setenv("RPE_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("RPE_EXTRACT_T_NBODY", "1")
    with _fresh_reference():
        orb_j = jax.jit(lambda im: jorb.orb_detect_and_describe(im, **kw,
                                                                **KW))
        refs = [{k: np.asarray(v) for k, v in orb_j(
            jnp.asarray(frames[i])).items()} for i in range(n)]
    for i, ref in enumerate(refs):
        t = {k: v[i].numpy() for k, v in got.items()}
        for k in ("xy", "level", "valid"):
            np.testing.assert_array_equal(ref[k], t[k], err_msg=k)
        v = ref["valid"]
        assert v.sum() > 200
        assert (ref["bits"][v] == t["bits"][v]).mean() >= 0.999
        np.testing.assert_allclose(t["angle"][v], ref["angle"][v], atol=1e-3)


PATCH_ROUTES = {"extract_patches_t": {"RPE_EXTRACT_T_BRIEF": "0"},
                "extract_patches_moments": {"RPE_EXTRACT_T": "0"},
                "extract_patches": {"RPE_EXTRACT_T": "0",
                                    "RPE_EXTRACT_MOMENTS": "0"}}


@pytest.mark.parametrize("route", list(PATCH_ROUTES))
def test_patch_routes_describe_with_the_cv2_pattern(monkeypatch, frames,
                                                    route):
    """Under RPE_BRIEF=cv2 the K8-K10 routes' BRIEF (the plain steered
    functions after the patch kernel) takes OpenCV's pattern and the
    rounding it turns on, as the reference's does after its patch kernels:
    the same keypoints and >= 0.999 of the bits of the default route,
    which test_orb_switches_match_reference holds to the reference."""
    monkeypatch.setenv("RPE_BRIEF", "cv2")
    imgs = torch.from_numpy(frames[:1])
    want = torb.orb_detect_and_describe(imgs, **KW)
    for k, v in PATCH_ROUTES[route].items():
        monkeypatch.setenv(k, v)
    assert textract.extract_route() == route
    got = torb.orb_detect_and_describe(imgs, **KW)
    for k in ("xy", "level", "valid"):
        assert torch.equal(got[k], want[k]), k
    v = want["valid"]
    assert int(v.sum()) > 200
    assert float((got["bits"] == want["bits"])[v].float().mean()) >= 0.999
    monkeypatch.setenv("RPE_BRIEF", "gauss")
    gauss = torb.orb_detect_and_describe(imgs, **KW)
    assert float((gauss["bits"] != got["bits"])[v].float().mean()) > 0.2


# ---- LO-RANSAC --------------------------------------------------------------

PAIRS = ((150, 165), (300, 315), (690, 705))


@pytest.fixture(scope="module")
def matches():
    """The reference's recorded simulator matches (tests/data), normalised,
    as tests/test_torch_geometry.py batches them."""
    n1, n2, mv, thr = [], [], [], []
    for f1, f2 in PAIRS:
        z = np.load(DATA / f"sim_matches_{f1}_{f2}.npz")
        K = jnp.asarray(z["K"], jnp.float32)
        n1.append(np.asarray(jepi.normalize_points(jnp.asarray(z["pts1"]),
                                                   K)))
        n2.append(np.asarray(jepi.normalize_points(jnp.asarray(z["pts2"]),
                                                   K)))
        mv.append(z["mvalid"])
        thr.append(np.float32(1.0) / (np.float32(0.5) * (K[0, 0] + K[1, 1])))
    keys = np.asarray(jax.vmap(jax.random.PRNGKey)(np.arange(len(PAIRS))))
    return (np.stack(n1), np.stack(n2), np.stack(mv),
            np.asarray(thr, np.float32), keys)


@pytest.mark.parametrize("solver,pairs", [("5pt", [0, 1, 2]),
                                          ("8pt", [1, 2])])
def test_lo_ransac_matches_reference(matches, solver, pairs):
    """ransac_essential(lo=True) on the pair axis against the reference per
    pair: equal inlier masks and counts, E within 1e-4 up to sign. With
    the 8-point solver pair 150->165 is left out: its minimal solves
    differ in float32 by up to 0.02 in E (ROADMAP.md, Known divergences),
    which there changes the winner that LO starts from."""
    n1, n2, mv, thr, keys = matches
    refs = [{k: np.asarray(v) for k, v in jran.ransac_essential(
        jnp.asarray(keys[i]), jnp.asarray(n1[i]), jnp.asarray(n2[i]),
        jnp.asarray(mv[i]), thr[i], num_hypotheses=128, solver=solver,
        lo=True).items()} for i in pairs]
    got = tran.ransac_essential(
        convert.keys_from_numpy(keys[pairs]), torch.from_numpy(n1[pairs]),
        torch.from_numpy(n2[pairs]), torch.from_numpy(mv[pairs]),
        torch.from_numpy(thr[pairs]), num_hypotheses=128, solver=solver,
        lo=True)
    plain = tran.ransac_essential(
        convert.keys_from_numpy(keys[pairs]), torch.from_numpy(n1[pairs]),
        torch.from_numpy(n2[pairs]), torch.from_numpy(mv[pairs]),
        torch.from_numpy(thr[pairs]), num_hypotheses=128, solver=solver)
    for j, ref in enumerate(refs):
        assert ref["ok"]
        np.testing.assert_array_equal(got["inlier_mask"][j].numpy(),
                                      ref["inlier_mask"])
        assert int(got["num_inliers"][j]) == int(ref["num_inliers"])
        a = ref["E"].ravel().astype(np.float64)
        b = got["E"][j].numpy().ravel().astype(np.float64)
        np.testing.assert_allclose(b, np.sign(a @ b) * a, atol=1e-4)
    assert not torch.equal(got["E"], plain["E"])


# ---- unpack_descriptor_bits, calibration ------------------------------------

def test_unpack_descriptor_bits_equal():
    g = np.random.default_rng(2)
    packed = g.integers(0, 256, (3, 50, 32)).astype(np.uint8)
    want = np.asarray(jmatch.unpack_descriptor_bits(jnp.asarray(packed)))
    got = tmatch.unpack_descriptor_bits(torch.from_numpy(packed))
    assert got.dtype == torch.uint8 and got.shape == (3, 50, 256)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.unpackbits(packed, axis=-1, bitorder="little"))
    np.testing.assert_array_equal(
        tmatch.unpack_descriptor_bits(packed[0]).numpy(), want[0])


def _views(g, n_views, noise, bad=()):
    """Seeded synthetic chessboard views, as tests/test_calibrate.py makes
    them (K, k1 = -0.08, k2 = 0.02, 7x7 board), the views in `bad` moved by
    8 px noise."""
    K = np.array([[800.0, 0, 480.0], [0, 790.0, 360.0], [0, 0, 1.0]])
    dist = np.array([-0.08, 0.02])
    obj = jcal.make_object_points(7, 7, 0.04)
    obj_points, img_points = [], []
    for v in range(n_views):
        rvec = g.normal(size=3) * 0.35
        tvec = np.array([g.uniform(-0.1, 0.1), g.uniform(-0.1, 0.1),
                         g.uniform(0.5, 1.0)])
        tvec[:2] -= (jcal.so3_exp(rvec) @ obj.mean(0))[:2]
        pts = jcal.project(obj, K, dist, rvec, tvec)
        pts = pts + g.normal(size=pts.shape) * (8.0 if v in bad else noise)
        obj_points.append(obj)
        img_points.append(pts)
    return obj_points, img_points


def test_calibrate_camera_matches_reference():
    """calibrate_camera: K and dist within 1e-6 relative, rms and poses
    too; the board and the projection are the reference's."""
    np.testing.assert_array_equal(tcal.make_object_points(7, 6, 0.03),
                                  jcal.make_object_points(7, 6, 0.03))
    obj, img = _views(np.random.default_rng(0), 8, 0.1)
    rj, Kj, dj, rvj, tvj = jcal.calibrate_camera(obj, img, (960, 720))
    rt, Kt, dt, rvt, tvt = tcal.calibrate_camera(obj, img, (960, 720))
    np.testing.assert_allclose(Kt, Kj, rtol=1e-6)
    np.testing.assert_allclose(dt, dj, rtol=1e-6)
    assert abs(rt - rj) <= 1e-6 * rj and rt < 0.2
    np.testing.assert_allclose(np.stack(rvt), np.stack(rvj), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(np.stack(tvt), np.stack(tvj), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(
        tcal.project(obj[0], Kt, dt, rvt[0], tvt[0]),
        jcal.project(obj[0], Kj, dj, rvj[0], tvj[0]), rtol=1e-9)


def test_calibrate_with_filtering_matches_reference():
    """calibrate_with_filtering on 12 views, two of them corrupted: the
    same views dropped, K and dist within 1e-6 relative."""
    obj, img = _views(np.random.default_rng(1), 12, 0.05, bad=(3, 7))
    want = jcal.calibrate_with_filtering(obj, img, (960, 720),
                                         error_threshold=1.0, min_keep=5)
    got = tcal.calibrate_with_filtering(obj, img, (960, 720),
                                        error_threshold=1.0, min_keep=5)
    np.testing.assert_array_equal(got[4], want[4])
    assert not got[4][3] and not got[4][7] and got[4].sum() == 10
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-6)
    assert abs(got[0] - want[0]) <= 1e-6 * want[0]
