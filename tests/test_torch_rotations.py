"""rpe_tpu_torch.geometry.rotations against rpe_tpu.geometry.rotations on
seeded inputs, both gimbal-lock branches included.

Tolerances: the float32 tensor functions within 1e-6 (matrix entries and
so(3) vectors, in radians) and 1e-5 deg (angles); the float64 `*_np` twins
exactly. Angles past 128 deg have a float32 ulp of 1.5e-5 deg, so angles
are held within 1e-5 deg plus a relative 2^-23 (one ulp). The geodesic and
direction errors are arccos of a float32 cosine, which near 0 and 180 deg
turns the cosine's last-bit rounding into up to 1e-4 deg: their cosines
are held within 1e-6 everywhere, and the angles as above between 20 and
160 deg. Both packages take float64 numpy inputs to float32 (the reference
runs without 64-bit mode), so the inputs are the same numbers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpe_tpu.geometry import rotations as jr
from rpe_tpu_torch.geometry import rotations as tr

RAD = 1e-6
DEG = 1e-5
ULP = 2.0 ** -23


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, atol):
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=ULP if atol == DEG else 0,
                               atol=atol)


@pytest.fixture(scope="module")
def inputs():
    g = np.random.default_rng(7)
    n = 64
    ypr = g.uniform(-180.0, 180.0, size=(3, n))
    ypr[1] = g.uniform(-89.0, 89.0, size=n)
    # rotations whose R[2, 1] is near +-1 (the yup lock branch), on both
    # sides of the 0.9999 threshold, and whose first column is ~0 (the zyx
    # singular branch)
    def rz(b):
        c, s = np.cos(b), np.sin(b)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])

    def rx(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])

    def ry(a):
        c, s = np.cos(a), np.sin(a)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])

    locked = [rz(b) @ rx(np.deg2rad(a)) for b in g.uniform(-3, 3, 6)
              for a in (90.0, -90.0, 89.5, -89.5, 89.9, 89.1)]
    singular = [rz(b) @ ry(np.deg2rad(a)) @ rx(c) for b, c in
                g.uniform(-3, 3, (6, 2)) for a in (90.0, -90.0)]
    w = g.normal(size=(n, 3)) * g.uniform(0.0, 1.0, size=(n, 1))
    w[:4] *= 1e-8                                  # the small-angle branch
    R = jr.euler_to_rotation_np(*ypr)
    t = g.normal(size=(n, 3))
    return {"ypr": ypr, "locked": np.stack(locked),
            "singular": np.stack(singular), "w": w, "R": R,
            "R2": jr.euler_to_rotation_np(*g.uniform(-60, 60, size=(3, n))),
            "t": t, "t2": t + 0.3 * g.normal(size=(n, 3)),
            "err": g.uniform(-720.0, 720.0, size=200)}


@pytest.mark.parametrize("conv", ["yup", "zyx"])
def test_euler_to_rotation(inputs, conv):
    y, p, r = inputs["ypr"]
    fn = {"yup": "euler_to_rotation_yup", "zyx": "euler_to_rotation_zyx"}[conv]
    _close(getattr(tr, fn)(y, p, r), getattr(jr, fn)(y, p, r), RAD)
    _close(tr.euler_to_rotation(y, p, r, conv),
           jr.euler_to_rotation(y, p, r, conv), RAD)
    # scalars broadcast like arrays
    _close(tr.euler_to_rotation(10.0, -20.0, 30.0, conv),
           jr.euler_to_rotation(10.0, -20.0, 30.0, conv), RAD)


@pytest.mark.parametrize("conv", ["yup", "zyx"])
def test_rotation_to_euler(inputs, conv):
    fn = {"yup": "rotation_to_euler_yup", "zyx": "rotation_to_euler_zyx"}[conv]
    Rs = np.concatenate([inputs["R"], inputs["locked"], inputs["singular"]])
    r21 = np.abs(Rs[:, 2, 1])
    sy = np.hypot(Rs[:, 0, 0], Rs[:, 1, 0])
    # both branches of both conventions are reached
    assert (r21 > 0.9999).sum() >= 6 and (r21 <= 0.9999).sum() >= 6
    assert (sy < 1e-6).sum() >= 6
    for got, want in zip(getattr(tr, fn)(Rs), getattr(jr, fn)(Rs)):
        _close(got, want, DEG)
    for got, want in zip(tr.rotation_to_euler(Rs, conv),
                         jr.rotation_to_euler(Rs, conv)):
        _close(got, want, DEG)


def test_so3_exp_log(inputs):
    w = inputs["w"]
    Rt, Rj = tr.so3_exp(w), jr.so3_exp(w)
    _close(Rt, Rj, RAD)
    _close(tr.so3_log(inputs["R2"]), jr.so3_log(inputs["R2"]), RAD)
    _close(tr.so3_log(np.array(Rj)), jr.so3_log(Rj), RAD)


def _close_acos(got, want):
    got, want = _np(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(np.cos(np.radians(got.astype(np.float64))),
                               np.cos(np.radians(want.astype(np.float64))),
                               rtol=0, atol=RAD)
    mid = (want > 20.0) & (want < 160.0)
    assert mid.sum() >= 10
    _close(got[mid], want[mid], DEG)


def test_error_metrics(inputs):
    R, R2 = inputs["R"], inputs["R2"]
    _close_acos(tr.rotation_error(R, R2), jr.rotation_error(R, R2))
    t, t2 = inputs["t"], inputs["t2"]
    _close_acos(tr.translation_direction_error(t, t2),
                jr.translation_direction_error(t, t2))
    _close_acos(tr.translation_direction_error(t[..., None], t2[..., None]),
                jr.translation_direction_error(t[..., None], t2[..., None]))
    _close(tr.wrap_angle_error(inputs["err"]),
           jr.wrap_angle_error(inputs["err"]), DEG)


def test_tensors_keep_their_dtype_and_device(inputs):
    R = torch.from_numpy(inputs["R"])
    assert tr.rotation_error(R, R).dtype == torch.float64
    y, p, r = (torch.from_numpy(a) for a in inputs["ypr"])
    out = tr.euler_to_rotation(y, p, r)
    assert out.dtype == torch.float64 and out.device == y.device
    np.testing.assert_allclose(out.numpy(), jr.euler_to_rotation_np(
        *inputs["ypr"]), rtol=0, atol=1e-12)


@pytest.mark.parametrize("conv", ["yup", "zyx"])
def test_numpy_twins_exact(inputs, conv):
    y, p, r = inputs["ypr"]
    np.testing.assert_array_equal(tr.euler_to_rotation_np(y, p, r, conv),
                                  jr.euler_to_rotation_np(y, p, r, conv))
    R, R2 = inputs["R"], inputs["R2"]
    np.testing.assert_array_equal(tr.rotation_error_np(R, R2),
                                  jr.rotation_error_np(R, R2))
    t, t2 = inputs["t"], inputs["t2"]
    np.testing.assert_array_equal(tr.translation_direction_error_np(t, t2),
                                  jr.translation_direction_error_np(t, t2))
    np.testing.assert_array_equal(
        tr.translation_direction_error_np(t[..., None], t2[..., None]),
        jr.translation_direction_error_np(t[..., None], t2[..., None]))
    assert jnp.asarray(0.0).dtype == jnp.float32   # the reference's precision
