"""rpe_tpu_torch detection against rpe_tpu on the CPU: the pyramid atlas,
the plain versions of K1 (FAST/Harris rank map + blur) and K2 (extraction
+ IC moments + steered BRIEF), the band tables, and ORB end to end. The
same numpy arrays go to both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpe_tpu.ops import atlas as jatlas
from rpe_tpu.ops import fast as jfast
from rpe_tpu.ops import orb as jorb
from rpe_tpu_torch.ops import atlas as tatlas
from rpe_tpu_torch.ops import extract as textract
from rpe_tpu_torch.ops import fast as tfast
from rpe_tpu_torch.ops import orb as torb
from rpe_tpu_torch.utils.synthetic import make_sequence
from torch_gates import default_extraction_gates  # noqa: F401

H, W, NLEV = 160, 320, 4


@pytest.fixture(scope="module")
def frames():
    return make_sequence(2, H, W, seed=3)[0]


@pytest.fixture(scope="module")
def jax_atlas(frames):
    atlas, layout = jatlas.build_atlas_fused(jnp.asarray(frames[0]), NLEV,
                                             1.1)
    return np.array(atlas), layout


def test_atlas_matches_reference(frames, jax_atlas):
    atlas, (offsets, total, wp) = tatlas.build_atlas_fused(
        torch.from_numpy(frames[:1]), NLEV, 1.1)
    assert atlas.shape == (1, total, wp)
    np.testing.assert_allclose(atlas[0].numpy(), jax_atlas[0], atol=1e-3,
                               rtol=0)


def test_fast_harris_plain_matches_reference(jax_atlas):
    a = jax_atlas[0]
    img = jnp.asarray(a)
    score = jfast.nonmax_suppress_3x3(jfast.fast_score_map(img, 15.0))
    rank_j = np.asarray(jnp.where(score > 0.0, jfast.harris_response_map(img),
                                  -jnp.inf))
    blur_j = np.asarray(jatlas.gaussian_blur_rolled(img))
    rank_t, blur_t = tfast.fast_harris_rank_map(torch.from_numpy(a[None]),
                                                15.0)
    rank_t, blur_t = rank_t[0].numpy(), blur_t[0].numpy()
    fin = np.isfinite(rank_j)
    np.testing.assert_array_equal(fin, np.isfinite(rank_t))
    assert fin.sum() > 500
    rel = np.abs(rank_t[fin] - rank_j[fin]) / (np.abs(rank_j[fin]) + 1e-3)
    assert rel.max() < 1e-3
    np.testing.assert_allclose(blur_t, blur_j, atol=1e-3, rtol=0)


def _keypoints(seed, ha, wp, k=300):
    """Atlas keypoints with clustered rows (some bands overflow their cap)
    and invalid slots."""
    g = np.random.default_rng(seed)
    y = np.concatenate([g.integers(20, ha - 40, k - 80),
                        g.integers(100, 104, 80)])
    x = g.integers(16, wp - 16, k)
    xy = np.stack([x, y], -1).astype(np.float32)
    valid = g.uniform(size=k) < 0.9
    return xy, valid


@pytest.mark.parametrize("band,cap", [(32, 72), (8, 24), (8, 12)])
def test_band_tables_match_reference(jax_atlas, band, cap):
    a = jax_atlas[0]
    ha, wp = a.shape
    xy, valid = _keypoints(band + cap, ha, wp)
    ref = jatlas.banded_extract(jnp.asarray(a), jnp.asarray(a),
                                jnp.asarray(xy), jnp.asarray(valid), cap=cap,
                                band=band)
    got = tatlas.band_tables(ha, wp, torch.from_numpy(xy[None]),
                             torch.from_numpy(valid[None]), cap=cap,
                             band=band)
    for k in ("tbl_x0", "rel_y", "tbl_used", "order", "slot_of_sorted",
              "valid_sorted"):
        np.testing.assert_array_equal(np.asarray(ref[k]), got[k][0].numpy(),
                                      err_msg=k)


def test_extract_brief_plain_matches_reference(jax_atlas):
    a = jax_atlas[0]
    ha, wp = a.shape
    blur = np.array(jatlas.gaussian_blur_rolled(jnp.asarray(a)))
    xy, valid = _keypoints(11, ha, wp)
    ref = jatlas.banded_extract(jnp.asarray(a), jnp.asarray(blur),
                                jnp.asarray(xy), jnp.asarray(valid), cap=72,
                                band=32)
    mask, us, vs = jorb._ic_angle_masks()
    raw = ref["patches_raw"]
    m10_j = np.asarray(jnp.sum(raw * (mask * us), axis=(1, 2)))
    m01_j = np.asarray(jnp.sum(raw * (mask * vs), axis=(1, 2)))
    ang_j = np.asarray(jorb.ic_angles(raw))
    bits_j = np.asarray(jorb.steered_brief(ref["patches_blur"], ang_j))
    ang_t = torb.ic_angles(torch.from_numpy(np.array(raw)))
    live_ang = np.hypot(m10_j, m01_j) > 1.0
    np.testing.assert_allclose(ang_t.numpy()[live_ang], ang_j[live_ang],
                               atol=1e-4)
    bits, m10, m01 = textract.extract_brief(
        torch.from_numpy(a[None]), torch.from_numpy(blur[None]),
        torch.from_numpy(np.asarray(ref["tbl_x0"])[None]),
        torch.from_numpy(np.asarray(ref["rel_y"])[None]), 32)
    live = np.asarray(ref["rel_y"]).reshape(-1) >= 0
    assert live.sum() > 100
    agree = (bits[0].numpy()[live] == bits_j[live]).mean()
    assert agree >= 0.999, agree
    np.testing.assert_allclose(m10[0].numpy(), m10_j, rtol=1e-4, atol=2.0)
    np.testing.assert_allclose(m01[0].numpy(), m01_j, rtol=1e-4, atol=2.0)
    assert not bits[0].numpy()[~live].any()
    assert not m10[0].numpy()[~live].any() and not m01[0].numpy()[~live].any()


def test_orb_detection_matches_reference(frames):
    kw = dict(nfeatures=256, nlevels=NLEV, max_kpts=256, extract_cap=72,
              band=32)
    got = torb.orb_detect_and_describe_atlas(torch.from_numpy(frames), **kw)
    for i in range(len(frames)):
        ref = {k: np.asarray(v) for k, v in jorb.orb_detect_and_describe(
            jnp.asarray(frames[i]), **kw).items()}
        t = {k: v[i].numpy() for k, v in got.items()}
        for k in ("xy", "level", "valid"):
            np.testing.assert_array_equal(ref[k], t[k], err_msg=k)
        v = ref["valid"]
        assert v.sum() > 200
        assert (ref["bits"][v] == t["bits"][v]).mean() >= 0.999
        np.testing.assert_allclose(t["angle"][v], ref["angle"][v], atol=1e-3)
        np.testing.assert_allclose(t["score"][v], ref["score"][v], rtol=1e-3)
