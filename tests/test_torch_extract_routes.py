"""The ORB extraction routes of rpe_tpu_torch against rpe_tpu on the CPU:
the kernel gates and the route each setting selects, the plain versions of
K8, K9, K10 and K12 against the reference's Pallas kernels in interpret
mode and against its XLA one-hot patches, the binned-steering tables, the
plain K5 against the reference's grid-and-bisect construction, ORB end to
end under each route's gates and under the reference's other switches
(RPE_BRIEF_QUANT, RPE_NO_ATLAS, RPE_NO_FUSED_ATLAS). The same numpy arrays
go to both packages."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpe_tpu.geometry import five_point as jfp
from rpe_tpu.ops import atlas as jatlas
from rpe_tpu.ops import extract_pallas as jext
from rpe_tpu.ops import fast as jfast
from rpe_tpu.ops import orb as jorb
from rpe_tpu_torch.config import EstimatorConfig, OrbConfig
from rpe_tpu_torch.geometry import five_point as tfp
from rpe_tpu_torch.ops import extract as textract
from rpe_tpu_torch.ops import fast as tfast
from rpe_tpu_torch.ops import orb as torb
from rpe_tpu_torch.pipeline.estimator import detect_features
from rpe_tpu_torch.utils.synthetic import make_sequence
from torch_gates import default_extraction_gates  # noqa: F401

H, W, NLEV = 160, 320, 4
PATCH = 31

# ---- gates and routes -------------------------------------------------------

GATE_NAMES = sorted(jfast._VALIDATED_KERNEL_GATES) + [
    "RPE_EXTRACT_T_V7", "RPE_EXTRACT_T_V8", "RPE_EXTRACT_T_SPARSE",
    "RPE_EXTRACT_T_BRIEF_V4", "RPE_EXTRACT_T_NBODY"]
GATE_VALUES = [None, "", "0", "off", "OFF", " no ", "false", "False", "1",
               "on", "yes", "2", " true "]


@pytest.mark.parametrize("name", GATE_NAMES)
def test_kernel_gate_matches_reference(monkeypatch, name):
    assert tfast._VALIDATED_KERNEL_GATES == jfast._VALIDATED_KERNEL_GATES
    for value in GATE_VALUES:
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
        assert tfast.kernel_gate(name) == jfast.kernel_gate(name), value


# reference gate setting -> the port's route (rpe_tpu/ops/atlas.py:267-363
# as the TPU runs it)
ROUTE_TABLE = [
    ({}, "extract_brief"),
    ({"RPE_EXTRACT_T_BRIEF_V4": "1"}, "extract_brief"),
    ({"RPE_EXTRACT_T_SPARSE": "1"}, "extract_brief"),
    ({"RPE_EXTRACT_T_V8": "1"}, "extract_brief"),
    ({"RPE_EXTRACT_T_QUAD": "0"}, "extract_brief"),
    ({"RPE_PALLAS_EXTRACT": "0"}, "extract_brief"),
    ({"RPE_EXTRACT_T_NBODY": "1", "RPE_ONEHOT_BF16": "1", "RPE_NO_PALLAS": "1",
      "RPE_PALLAS_INTERPRET": "1"}, "extract_brief"),
    ({"RPE_EXTRACT_T_V7": "1"}, "extract_brief_binned"),
    ({"RPE_EXTRACT_T_V7": "1", "RPE_EXTRACT_T_V8": "1"}, "extract_brief"),
    ({"RPE_EXTRACT_T_BRIEF": "0"}, "extract_patches_t"),
    ({"RPE_EXTRACT_T_BRIEF": "off", "RPE_EXTRACT_T_V7": "1"},
     "extract_patches_t"),
    ({"RPE_EXTRACT_T": "0"}, "extract_patches_moments"),
    ({"RPE_EXTRACT_T": "0", "RPE_EXTRACT_MOMENTS": "0"}, "extract_patches"),
    ({"RPE_EXTRACT_T": "0", "RPE_PALLAS_EXTRACT": "0"}, "extract_patches"),
]


@pytest.mark.parametrize("gates,route", ROUTE_TABLE,
                         ids=[" ".join(f"{k}={v}" for k, v in g.items())
                              or "default" for g, _ in ROUTE_TABLE])
def test_extract_route_table(monkeypatch, gates, route):
    for k, v in gates.items():
        monkeypatch.setenv(k, v)
    assert textract.extract_route() == route


# ---- the plain K8, K9, K10, K12 against the reference's kernels -------------

BAND, CAP, NB, WP = 8, 24, 12, 256
WIN = BAND + 32


@pytest.fixture(scope="module")
def slots():
    """Random atlas and blur (NB * BAND, WP) and slot tables (NB, CAP): a
    third of the slots parked, and the last five bands, whose windows
    would pass the atlas's end, parked entirely (as in production)."""
    g = np.random.default_rng(21)
    atlas = g.uniform(0, 255, (NB * BAND, WP)).astype(np.float32)
    blurred = g.uniform(0, 255, (NB * BAND, WP)).astype(np.float32)
    x0 = g.integers(0, WP - PATCH + 1, (NB, CAP)).astype(np.int32)
    x0[0, 0] = WP - PATCH
    rel_y = g.integers(0, BAND, (NB, CAP)).astype(np.int32)
    parked = g.uniform(size=(NB, CAP)) < 0.3
    parked[NB - WIN // BAND:] = True
    rel_y[parked] = -31
    return atlas, blurred, x0, rel_y


def _windows(a):
    """The band windows of rpe_tpu/ops/atlas.py `banded_extract`."""
    pad = np.pad(a, ((0, WIN), (0, 0)))
    return np.stack([pad[b * BAND: b * BAND + WIN] for b in range(NB)])


def _port(slots_):
    atlas, blurred, x0, rel_y = (torch.from_numpy(a.copy())[None]
                                 for a in slots_)
    return atlas, blurred, x0, rel_y, BAND


def _unpad(a):
    """Reference (NB, CAP, 32, 32) -> (NB * CAP, 31, 31)."""
    return np.asarray(a)[:, :, :PATCH, :PATCH].reshape(-1, PATCH, PATCH)


def test_k8_plain_matches_reference_kernel(slots):
    atlas, blurred, x0, rel_y = slots
    raw_j, blur_j = jext.extract_windows(
        jnp.asarray(_windows(atlas)), jnp.asarray(_windows(blurred)),
        jnp.asarray(x0), jnp.asarray(rel_y), interpret=True)
    raw, blur = textract.extract_patches(*_port(slots))
    np.testing.assert_array_equal(raw[0].numpy(), _unpad(raw_j))
    np.testing.assert_array_equal(blur[0].numpy(), _unpad(blur_j))
    assert not raw[0].numpy()[rel_y.reshape(-1) < 0].any()


def test_k9_plain_matches_reference_kernel(slots):
    atlas, blurred, x0, rel_y = slots
    blur_j, m10_j, m01_j = jext.extract_windows_moments(
        jnp.asarray(_windows(atlas)), jnp.asarray(_windows(blurred)),
        jnp.asarray(x0), jnp.asarray(rel_y), interpret=True)
    blur, m10, m01 = textract.extract_patches_moments(*_port(slots))
    np.testing.assert_array_equal(blur[0].numpy(), _unpad(blur_j))
    m10_j, m01_j = np.asarray(m10_j).reshape(-1), np.asarray(m01_j).reshape(-1)
    live = np.hypot(m10_j, m01_j) > 1.0
    assert live.sum() > 100
    d = np.angle(np.exp(1j * (np.arctan2(m01[0].numpy(), m10[0].numpy())
                              - np.arctan2(m01_j, m10_j))))
    assert np.abs(d[live]).max() < 1e-4
    parked = rel_y.reshape(-1) < 0
    assert not m10[0].numpy()[parked].any()
    assert not m01[0].numpy()[parked].any()


def test_k10_plain_matches_reference_kernel(slots):
    atlas, blurred, x0, rel_y = slots
    blur_j, m10_j, m01_j = jext.extract_windows_t(
        jnp.asarray(atlas), jnp.asarray(blurred), jnp.asarray(x0),
        jnp.asarray(rel_y), interpret=True, band=BAND, nbody=1)
    blur_t, m10, m01 = textract.extract_patches_t(*_port(slots))
    np.testing.assert_array_equal(blur_t[0].numpy(), _unpad(blur_j))
    np.testing.assert_allclose(m10[0].numpy(), np.asarray(m10_j).reshape(-1),
                               rtol=1e-3, atol=2.0)
    np.testing.assert_allclose(m01[0].numpy(), np.asarray(m01_j).reshape(-1),
                               rtol=1e-3, atol=2.0)


def test_k12_plain_matches_reference_kernel(slots):
    atlas, blurred, x0, rel_y = slots
    args = (jnp.asarray(atlas), jnp.asarray(blurred), jnp.asarray(x0),
            jnp.asarray(rel_y))
    bits_j, m10_j, m01_j = jext.extract_windows_t_brief(
        *args, interpret=True, band=BAND, nbody=1, binned=True, quant=False)
    bits_j = np.asarray(bits_j).reshape(-1, 256)
    bits, m10, m01 = textract.extract_brief(*_port(slots), binned=True)
    live = rel_y.reshape(-1) >= 0
    agree = (bits[0].numpy()[live] == bits_j[live]).mean()
    assert agree >= 0.999, agree
    assert not bits[0].numpy()[~live].any() and not bits_j[~live].any()
    # the two twins are exact on the same transposed patches and moments
    blur_j, _, _ = jext.extract_windows_t(*args, interpret=True, band=BAND,
                                          nbody=1)
    m10_j, m01_j = np.asarray(m10_j).reshape(-1), np.asarray(m01_j).reshape(-1)
    want = np.asarray(jorb.steered_brief_t_binned(
        jnp.asarray(np.asarray(blur_j).reshape(-1, 32, 32)),
        jnp.asarray(m10_j), jnp.asarray(m01_j), quant=False))
    got = torb.steered_brief_t_binned(torch.from_numpy(_unpad(blur_j).copy()),
                                      torch.from_numpy(m10_j.copy()),
                                      torch.from_numpy(m01_j.copy()))
    np.testing.assert_array_equal(got.numpy(), want)


# ---- ... and against the reference's XLA one-hot patches --------------------

@pytest.fixture(scope="module")
def frames():
    return make_sequence(2, H, W, seed=3)[0]


@pytest.mark.parametrize("band,cap", [(8, 24), (32, 72)])
def test_patch_routes_match_reference_xla_patches(frames, band, cap):
    """On a real atlas and its banded_extract tables: K8's patches are the
    XLA path's exactly, K9 and K10 carry its blur patches and moments, and
    K12 gives steered_brief_t_binned's bits."""
    a_j, _ = jatlas.build_atlas_fused(jnp.asarray(frames[0]), NLEV, 1.1)
    b_j = jatlas.gaussian_blur_rolled(a_j)
    a, b = np.array(a_j), np.array(b_j)
    g = np.random.default_rng(band + cap)
    ha, wp = a.shape
    xy = np.stack([g.integers(16, wp - 16, 400), g.integers(20, ha - 40, 400)],
                  -1).astype(np.float32)
    ref = jatlas.banded_extract(a_j, b_j, jnp.asarray(xy),
                                jnp.asarray(g.uniform(size=400) < 0.9),
                                cap=cap, band=band)
    raw_x = np.asarray(ref["patches_raw"])
    blur_x = np.asarray(ref["patches_blur"])
    args = (torch.from_numpy(a[None]), torch.from_numpy(b[None]),
            torch.from_numpy(np.array(ref["tbl_x0"])[None]),
            torch.from_numpy(np.array(ref["rel_y"])[None]), band)
    raw, blur = textract.extract_patches(*args)
    np.testing.assert_array_equal(raw[0].numpy(), raw_x)
    np.testing.assert_array_equal(blur[0].numpy(), blur_x)

    mask, us, vs = jorb._ic_angle_masks()
    m10_x = np.asarray(jnp.sum(raw_x * (mask * us), axis=(1, 2)))
    m01_x = np.asarray(jnp.sum(raw_x * (mask * vs), axis=(1, 2)))
    blur9, m10, m01 = textract.extract_patches_moments(*args)
    np.testing.assert_array_equal(blur9[0].numpy(), blur_x)
    np.testing.assert_allclose(m10[0].numpy(), m10_x, rtol=1e-4, atol=2.0)
    np.testing.assert_allclose(m01[0].numpy(), m01_x, rtol=1e-4, atol=2.0)
    blur_t, m10_t, m01_t = textract.extract_patches_t(*args)
    np.testing.assert_array_equal(blur_t[0].numpy(),
                                  blur_x.transpose(0, 2, 1))
    assert torch.equal(m10_t, m10) and torch.equal(m01_t, m01)

    bits, _, _ = textract.extract_brief(*args, binned=True)
    want = np.asarray(jorb.steered_brief_t_binned(
        jnp.asarray(blur_x.transpose(0, 2, 1)), jnp.asarray(m10_x),
        jnp.asarray(m01_x), quant=False))
    live = np.asarray(ref["rel_y"]).reshape(-1) >= 0
    assert live.sum() > 200
    assert (bits[0].numpy()[live] == want[live]).mean() >= 0.999


def test_brief_bin_tables_and_angle_bins_exact():
    ix_j, iy_j, _, _ = jorb.brief_bin_tables()
    ix, iy = torb.brief_bin_tables()
    np.testing.assert_array_equal(ix, ix_j)
    np.testing.assert_array_equal(iy, iy_j)
    for a, b in zip(torb.brief_bin_vectors(), jorb.brief_bin_vectors()):
        np.testing.assert_array_equal(a, b)
    g = np.random.default_rng(4)
    cosb, sinb = jorb.brief_bin_vectors()
    half = np.pi / torb.N_BRIEF_BINS * (2 * np.arange(30) + 1)
    m10 = np.concatenate([g.normal(0, 300, 4000), [0.0, 0.0, -0.0, 1e-3],
                          50 * cosb, 80 * np.cos(half)]).astype(np.float32)
    m01 = np.concatenate([g.normal(0, 300, 4000), [0.0, -0.0, 0.0, 0.0],
                          50 * sinb, 80 * np.sin(half)]).astype(np.float32)
    got = torb.angle_bins(torch.from_numpy(m10), torch.from_numpy(m01))
    want = np.asarray(jorb.angle_bins(jnp.asarray(m10), jnp.asarray(m01)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got[4000:4003] == 0).all()


# ---- K9's and K10's warp-per-slot layout, modelled in numpy -----------------

PATCH_SOURCE = (Path(textract.__file__).resolve().parents[1] / "csrc"
                / "extract_patches.cu")


def _patch_warps():
    m = re.search(r"#define WARPS (\d+)", PATCH_SOURCE.read_text())
    assert m, "WARPS not found in extract_patches.cu"
    return int(m.group(1))


def _patch_blocks(f, nb, cap):
    """csrc/extract_patches.cu's K9/K10 grid: block k owns the flat slots
    k * WARPS + w (w < WARPS, below F * NB * CAP); a warp finds (f, b, s) as
    the kernel does. Yields (first slot, [(slot, f, b, s), ...])."""
    warps, n = _patch_warps(), f * nb * cap
    for first in range(0, n, warps):
        slots = []
        for so in range(first, min(first + warps, n)):
            fb = so // cap
            ff = fb // nb
            slots.append((so, ff, fb - ff * nb, so - fb * cap))
        yield first, slots


def _staged_index(transposed):
    """Shared-memory index of pixel (row r, column c) within a warp's 961
    floats: s[c * 31 + r] for K10, s[r * 31 + c] for K9."""
    r, c = np.mgrid[0:PATCH, 0:PATCH]
    return c * PATCH + r if transposed else r * PATCH + c


@pytest.mark.parametrize("cap", [72, 71, 1])
def test_patch_blocks_cover_every_slot_once(cap):
    """Every slot of (F, NB, CAP) lies in exactly one block; each full
    block's output run starts at a multiple of 16 bytes and spans a whole
    number of 16-byte stores; only the last block may be partial."""
    f, nb, warps = 3, 5, _patch_warps()
    seen = np.zeros((f, nb, cap), np.int64)
    blocks = list(_patch_blocks(f, nb, cap))
    for first, slots in blocks:
        for so, ff, b, s in slots:
            assert np.ravel_multi_index((ff, b, s), (f, nb, cap)) == so
            seen[ff, b, s] += 1
        if len(slots) == warps:
            assert first * PATCH * PATCH * 4 % 16 == 0
            assert warps * PATCH * PATCH * 4 % 16 == 0
    assert (seen == 1).all()
    assert [len(sl) for _, sl in blocks[:-1]] == [warps] * (len(blocks) - 1)
    assert len(blocks[-1][1]) == ((f * nb * cap) % warps or warps)


def _staged_patches(blurred, x0, rel_y, band, transposed):
    """K9's (K10's) blurred output as the kernel writes it: each warp
    stages its slot's pixels (rows and columns clamped to the atlas) at
    `_staged_index` in its block's shared run, a parked warp zeros; the run
    is then stored in order from the block's first slot."""
    f, ha, wp = blurred.shape
    _, nb, cap = x0.shape
    npix = PATCH * PATCH
    out = np.full(f * nb * cap * npix, np.nan, np.float32)
    idx = _staged_index(transposed)
    pj = np.arange(PATCH)
    for first, slots in _patch_blocks(f, nb, cap):
        run = np.full(_patch_warps() * npix, np.nan, np.float32)
        for w, (_, ff, b, s) in enumerate(slots):
            sb = run[w * npix:(w + 1) * npix]
            if rel_y[ff, b, s] < 0:
                sb[:] = 0.0
                continue
            rows = np.clip(b * band + rel_y[ff, b, s] + pj, 0, ha - 1)
            cols = np.clip(x0[ff, b, s] + pj, 0, wp - 1)
            sb[idx] = blurred[ff][rows[:, None], cols[None, :]]
        out[first * npix:(first + len(slots)) * npix] = \
            run[:len(slots) * npix]
    return out.reshape(f, nb * cap, PATCH, PATCH)


@pytest.mark.parametrize("transposed", [False, True], ids=["k9", "k10"])
def test_staged_run_gives_plain_patches(transposed):
    """Staging at `_staged_index` and storing the runs gives the plain
    versions' patches (K10: `extract_patches_t_plain`'s transpose) on
    slots live, parked and past the atlas edge, with a partial last
    block."""
    src = PATCH_SOURCE.read_text()
    assert "lane * PATCH + r" in src and "r * PATCH + lane" in src
    g = np.random.default_rng(17)
    f, nb, cap, band, wp = 2, 3, 7, 16, 64
    ha = nb * band
    atlas = g.uniform(0, 255, (f, ha, wp)).astype(np.float32)
    blurred = g.uniform(0, 255, (f, ha, wp)).astype(np.float32)
    x0 = g.integers(0, wp - 4, (f, nb, cap)).astype(np.int32)
    rel_y = g.integers(0, band, (f, nb, cap)).astype(np.int32)
    rel_y[g.uniform(size=rel_y.shape) < 0.3] = -31
    x0[:, -1, 0], rel_y[:, -1, 0] = wp - 5, band - 1      # past both edges
    assert (f * nb * cap) % _patch_warps()
    got = _staged_patches(blurred, x0, rel_y, band, transposed)
    plain = (textract.extract_patches_t_plain if transposed
             else textract.extract_patches_moments_plain)
    want = plain(*(torch.from_numpy(a) for a in (atlas, blurred, x0, rel_y)),
                 band)[0].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("transposed", [False, True], ids=["k9", "k10"])
def test_staging_rows_hit_distinct_banks(transposed):
    """The 31 copying lanes of each staging row (cp.async per row r, lane
    c) write 31 distinct shared-memory banks, in every warp of a block."""
    idx = _staged_index(transposed)
    for w in range(_patch_warps()):
        for r in range(PATCH):
            banks = (w * PATCH * PATCH + idx[r, :]) % 32
            assert len(set(banks.tolist())) == PATCH


# ---- K5 ---------------------------------------------------------------------

@jax.jit
def _reference_brackets(coeffs):
    """The reference's XLA grid + bisection brackets
    (tests/test_pallas_kernels.py:104-125)."""
    b = coeffs.shape[0]
    t = jnp.linspace(-0.5 * jnp.pi + 1e-3, 0.5 * jnp.pi - 1e-3, jfp.GRID)
    d = jfp._detM_at(coeffs[:, None], jnp.broadcast_to(jnp.tan(t),
                                                       (b, jfp.GRID)))
    sign = jnp.sign(d)
    change = (sign[..., :-1] * sign[..., 1:]) < 0
    score = jnp.where(change, -jnp.arange(jfp.GRID - 1, dtype=jnp.float32),
                      -jnp.inf)
    _, bidx = jax.lax.top_k(score, jfp.MAX_ROOTS)
    has = jnp.take_along_axis(change, bidx, axis=-1)
    lo, hi = jnp.take(t, bidx), jnp.take(t, bidx + 1)
    dlo = jnp.take_along_axis(d, bidx, axis=-1)
    for _ in range(jfp.BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        dm = jfp._detM_at(coeffs[:, None], jnp.tan(mid))
        same = (jnp.sign(dm) * jnp.sign(dlo)) >= 0
        lo, hi, dlo = (jnp.where(same, mid, lo), jnp.where(same, hi, mid),
                       jnp.where(same, dm, dlo))
    return lo, hi, has


def test_root_brackets_plain_matches_reference_xla():
    """K5's contract (tests/test_pallas_kernels.py:92-140): identical
    has_root, endpoints within one grid step, >= 90% within two final
    bisection widths; empty slots 0, 0."""
    g = np.random.default_rng(9)
    pts = torch.from_numpy(g.uniform(-0.5, 0.5, (64, 5, 2, 2)).astype(
        np.float32))
    _, c = tfp.constraint_coeffs(pts[..., 0], pts[..., 1])
    lo_j, hi_j, has_j = (np.asarray(a) for a in
                         _reference_brackets(jnp.asarray(c.numpy())))
    lo, hi, has = (a.numpy() for a in tfp.find_root_brackets(c))
    np.testing.assert_array_equal(has, has_j)
    assert has.sum() > 64
    dt = float(np.pi / (tfp.GRID - 1))
    width = dt / (1 << tfp.BISECT_ITERS)
    dlo, dhi = np.abs(lo - lo_j)[has], np.abs(hi - hi_j)[has]
    assert dlo.max() <= dt and dhi.max() <= dt
    assert (dlo <= 2 * width).mean() > 0.9 and (dhi <= 2 * width).mean() > 0.9
    assert not lo[~has].any() and not hi[~has].any()


# ---- ORB end to end per route -----------------------------------------------

KW = dict(nfeatures=256, nlevels=NLEV, max_kpts=256, extract_cap=24, band=8)
E2E = [(g, r) for g, r in ROUTE_TABLE if g in (
    {"RPE_EXTRACT_T_V7": "1"}, {"RPE_EXTRACT_T_BRIEF": "0"},
    {"RPE_EXTRACT_T": "0"}, {"RPE_EXTRACT_T": "0", "RPE_EXTRACT_MOMENTS": "0"},
    {"RPE_EXTRACT_T": "0", "RPE_PALLAS_EXTRACT": "0"})]


@pytest.mark.parametrize("gates,route", E2E,
                         ids=[" ".join(f"{k}={v}" for k, v in g.items())
                              for g, _ in E2E])
def test_orb_route_matches_reference(monkeypatch, frames, gates, route):
    """The port under the reference's gates against rpe_tpu's ORB under the
    same gates, its Pallas extraction in interpret mode (one band per grid
    step, RPE_EXTRACT_T_NBODY=1, a layout setting that keeps the interpret
    program small): equal keypoints, bits >= 0.999, angles within 1e-3."""
    for k, v in gates.items():
        monkeypatch.setenv(k, v)
    assert textract.extract_route() == route
    got = torb.orb_detect_and_describe_atlas(torch.from_numpy(frames), **KW)
    monkeypatch.setenv("RPE_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("RPE_EXTRACT_T_NBODY", "1")
    for i in range(len(frames)):
        ref = {k: np.asarray(v) for k, v in jorb.orb_detect_and_describe(
            jnp.asarray(frames[i]), **KW).items()}
        t = {k: v[i].numpy() for k, v in got.items()}
        for k in ("xy", "level", "valid"):
            np.testing.assert_array_equal(ref[k], t[k], err_msg=k)
        v = ref["valid"]
        assert v.sum() > 200
        assert (ref["bits"][v] == t["bits"][v]).mean() >= 0.999
        np.testing.assert_allclose(t["angle"][v], ref["angle"][v], atol=1e-3)


# ---- the reference's other switches ----------------------------------------

# (switch, value, on) with the ids these cases have always had; `on` marks a
# value the reference reads as set (RPE_BRIEF_QUANT's parse, any non-empty
# RPE_NO_ATLAS or RPE_NO_FUSED_ATLAS)
SWITCH_CASES = [
    ("RPE_BRIEF_QUANT", "1", True, "RPE_BRIEF_QUANT-1-13"),
    ("RPE_BRIEF_QUANT", "yes", True, "RPE_BRIEF_QUANT-yes-13"),
    ("RPE_NO_ATLAS", "1", True, "RPE_NO_ATLAS-1-4"),
    ("RPE_NO_ATLAS", "0", True, "RPE_NO_ATLAS-0-4"),
    ("RPE_NO_FUSED_ATLAS", "1", True, "RPE_NO_FUSED_ATLAS-1-4"),
    ("RPE_BRIEF_QUANT", "0", False, "RPE_BRIEF_QUANT-0-None"),
    ("RPE_BRIEF_QUANT", "", False, "RPE_BRIEF_QUANT--None"),
    ("RPE_NO_ATLAS", "", False, "RPE_NO_ATLAS--None"),
]
_SWITCH_REFS = {}


@pytest.mark.parametrize("name,value,on", [c[:3] for c in SWITCH_CASES],
                         ids=[c[3] for c in SWITCH_CASES])
def test_unported_switches_raise(monkeypatch, frames, name, value, on):
    """Each switch computes on the device="cpu" path what it computes in
    the reference: ORB through the estimator's `detect_features` under a
    value the reference reads as set equals the reference's ORB under it
    (traced anew, so it reads the switch) -- keypoints equal, bits >=
    0.999, angles within 1e-3 -- and an off value gives the default
    output exactly."""
    cfg = EstimatorConfig(orb=OrbConfig(**KW))
    imgs = torch.from_numpy(frames[:1])
    if not on:
        default = detect_features(imgs, cfg)
        monkeypatch.setenv(name, value)
        got = detect_features(imgs, cfg)
        for k in default:
            assert torch.equal(got[k], default[k]), k
        return
    monkeypatch.setenv(name, value)
    got = {k: v[0].numpy() for k, v in detect_features(imgs, cfg).items()}
    if name not in _SWITCH_REFS:
        orb_j = jax.jit(lambda im: jorb.orb_detect_and_describe(im, **KW))
        _SWITCH_REFS[name] = {k: np.asarray(v) for k, v in
                              orb_j(jnp.asarray(frames[0])).items()}
    ref = _SWITCH_REFS[name]
    for k in ("xy", "level", "valid"):
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)
    v = ref["valid"]
    assert v.sum() > 200
    assert (ref["bits"][v] == got["bits"][v]).mean() >= 0.999
    np.testing.assert_allclose(got["angle"][v], ref["angle"][v], atol=1e-3)
