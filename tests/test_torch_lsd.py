"""rpe_tpu_torch.ops.lsd against rpe_tpu.ops.lsd on the CPU, on three
8-bit scenes made from seeds: two Manhattan rooms (utils/synthetic.py
`manhattan_sequence`, 120x160 and 160x240) and a block-textured frame
(`make_sequence`, 120x160).

Contracts:
- `_label_regions`: labels equal on every pixel (the shifts wrap at the
  edges as `jnp.roll` does). The level-line angles come from float32
  `atan2`, whose last bit differs between XLA's CPU polynomial and
  PyTorch's; the tests count the pixels whose angle gate could flip (the
  angle difference within 1e-5 rad of the 22.5 deg tolerance) and require
  equal labels all the same. A batch of frames labels as each frame alone.
- `detect_line_segments` (host twin, float64): the same segments, in the
  same order, within 1e-6 px (the magnitudes can differ in their last bit,
  XLA's square root not being correctly rounded).
- `detect_line_segments_device`: equal valid masks, segments within
  1e-3 px (float32 scatter sums)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpe_tpu.ops import lsd as jlsd
from rpe_tpu_torch.ops import lsd as tlsd
from rpe_tpu_torch.utils.synthetic import make_sequence, manhattan_sequence
from torch_gates import one_torch_thread  # noqa: F401


def _u8(f):
    return np.clip(np.rint(f), 0, 255).astype(np.float32)


@pytest.fixture(scope="module")
def scenes():
    m1 = manhattan_sequence(2, 120, 160)[0]
    m2 = manhattan_sequence(2, 160, 240, seed=3, rot_deg=1.0)[0]
    blocks = make_sequence(2, 120, 160, seed=1)[0]
    return {"room_120x160": _u8(m1[0]), "room_160x240": _u8(m2[1]),
            "blocks_120x160": _u8(blocks[0])}


@pytest.fixture(scope="module")
def labelled(scenes):
    out = {}
    for name, g in scenes.items():
        ref = tuple(np.asarray(x) for x in jlsd._label_regions(jnp.asarray(g)))
        got = tuple(x.numpy() for x in tlsd._label_regions(torch.from_numpy(g)))
        out[name] = ref, got
    return out


NAMES = ["room_120x160", "room_160x240", "blocks_120x160"]


@pytest.mark.parametrize("name", NAMES)
def test_label_regions_equal(labelled, name):
    (lj, aj, mj), (lt, at, mt) = labelled[name]
    assert lt.dtype == np.int32 and lt.shape == lj.shape
    # pixels whose gate to some neighbour sits within 1e-5 rad of the
    # tolerance, where an ulp of atan2 could decide it
    tol = np.float32(np.deg2rad(jlsd.ANGLE_TOL_DEG))
    edge = np.zeros(lj.shape, bool)
    for sh in [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0),
               (1, 1)]:
        d = np.abs(aj - np.roll(aj, sh, (0, 1)))
        d = np.minimum(d, 2 * np.pi - d)
        d = np.minimum(d, np.abs(d - np.pi))
        edge |= np.abs(d - tol) < 1e-5
    differ = int((lj != lt).sum())
    print(f"{name}: {differ} of {lj.size} labels differ "
          f"({differ / lj.size:.6f}); angles differing in float32: "
          f"{int((aj != at).sum())}; pixels at the gate's edge: "
          f"{int(edge.sum())}")
    np.testing.assert_array_equal(lt, lj)
    np.testing.assert_allclose(at, aj, rtol=0, atol=1e-6)
    np.testing.assert_allclose(mt, mj, rtol=1e-6, atol=0)
    assert (lt >= 0).any()


def test_label_regions_batched_equals_per_frame(scenes, labelled):
    g = np.stack([scenes["room_120x160"], scenes["blocks_120x160"]])
    lt, _, mt = tlsd._label_regions(torch.from_numpy(g))
    for i, name in enumerate(["room_120x160", "blocks_120x160"]):
        np.testing.assert_array_equal(lt[i].numpy(), labelled[name][1][0])
        np.testing.assert_array_equal(mt[i].numpy(), labelled[name][1][2])


@pytest.mark.parametrize("name", NAMES)
def test_detect_line_segments_host(scenes, name):
    want = jlsd.detect_line_segments(scenes[name])
    got = tlsd.detect_line_segments(scenes[name], device="cpu")
    assert got.dtype == np.float64 and got.shape == want.shape
    assert want.shape[0] >= 10
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_detect_line_segments_device(scenes, name):
    sj, vj = (np.asarray(x) for x in jlsd.detect_line_segments_device(
        jnp.asarray(scenes[name])))
    st, vt = tlsd.detect_line_segments_device(
        torch.from_numpy(scenes[name]))
    assert st.shape == (256, 4) and st.dtype == torch.float32
    np.testing.assert_array_equal(vt.numpy(), vj)
    assert vj.sum() >= 10
    np.testing.assert_allclose(st.numpy(), sj, rtol=0, atol=1e-3)


def test_detect_line_segments_device_batched(scenes):
    g = np.stack([scenes["room_120x160"], scenes["blocks_120x160"]])
    st, vt = tlsd.detect_line_segments_device(torch.from_numpy(g),
                                              max_segments=64)
    assert st.shape == (2, 64, 4)
    for i, name in enumerate(["room_120x160", "blocks_120x160"]):
        s1, v1 = tlsd.detect_line_segments_device(
            torch.from_numpy(scenes[name]), max_segments=64)
        np.testing.assert_array_equal(vt[i].numpy(), v1.numpy())
        np.testing.assert_allclose(st[i].numpy(), s1.numpy(), rtol=0,
                                   atol=1e-4)
