"""rpe_tpu_torch geometry against rpe_tpu on the CPU, fed identical inputs
and keys: the closed-form eigensolvers, the epipolar blocks,
recover_pose, the DEGENSAC rescue, the ambiguity blend and RANSAC.

Inputs are the reference's own recorded matches (tests/data/
sim_matches_*.npz), three simulator pairs batched on the port's pair axis.
Pair 150->165 is the reference's documented flat-likelihood pair
(rpe_tpu/geometry/ambiguity.py): there the DEGENSAC blend averages refit
candidates whose float32 reassociation differences it amplifies, so the
full-RANSAC parity with degensac holds the two clean pairs to the exact
contract, and the blend alone (identical input batch) is held to E at 1e-3
where it fires.
"""

import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rpe_tpu.geometry import ambiguity as jamb
from rpe_tpu.geometry import eig as jeig
from rpe_tpu.geometry import epipolar as jepi
from rpe_tpu.geometry import homography as jhom
from rpe_tpu.geometry import ransac as jran
from rpe_tpu.geometry.five_point import five_point_essential
from rpe_tpu_torch import convert
from rpe_tpu_torch.geometry import ambiguity as tamb
from rpe_tpu_torch.geometry import eig as teig
from rpe_tpu_torch.geometry import epipolar as tepi
from rpe_tpu_torch.geometry import homography as thom
from rpe_tpu_torch.geometry import ransac as tran

# both packages' geometry/__init__ export the function recover_pose under
# the submodule's name, so the modules are taken from the import system
jrp = importlib.import_module("rpe_tpu.geometry.recover_pose")
trp = importlib.import_module("rpe_tpu_torch.geometry.recover_pose")
DATA = Path(__file__).parent / "data"
PAIRS = ((150, 165), (300, 315), (690, 705))


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_E_close(Ej, Et, atol=1e-4):
    """E equal up to sign, per pair: (P, 3, 3)."""
    Ej, Et = np.asarray(Ej, np.float64), np.asarray(Et, np.float64)
    for a, b in zip(Ej.reshape(-1, 9), Et.reshape(-1, 9)):
        s = 1.0 if np.dot(a, b) >= 0 else -1.0
        np.testing.assert_allclose(b, s * a, atol=atol)


@pytest.fixture(scope="module")
def matches():
    """Normalized points (P, N, 2), masks (P, N), thresholds (P,)."""
    n1, n2, mv, thr = [], [], [], []
    for f1, f2 in PAIRS:
        z = np.load(DATA / f"sim_matches_{f1}_{f2}.npz")
        K = jnp.asarray(z["K"], jnp.float32)
        n1.append(np.asarray(jepi.normalize_points(jnp.asarray(z["pts1"]), K)))
        n2.append(np.asarray(jepi.normalize_points(jnp.asarray(z["pts2"]), K)))
        mv.append(z["mvalid"])
        thr.append(np.float32(1.0) / (np.float32(0.5) * (K[0, 0] + K[1, 1])))
    keys = np.asarray(jax.vmap(jax.random.PRNGKey)(np.arange(len(PAIRS))))
    return (np.stack(n1), np.stack(n2), np.stack(mv),
            np.asarray(thr, np.float32), keys)


def test_eigensolvers_match_reference():
    g = np.random.default_rng(0)
    A = g.normal(size=(64, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1)
    wj, Vj = (np.asarray(a) for a in jeig.eigh3x3_desc(jnp.asarray(A)))
    wt, Vt = (a.numpy() for a in teig.eigh3x3_desc(_t(A)))
    np.testing.assert_allclose(wt, wj, rtol=1e-5, atol=1e-5)
    dots = np.abs(np.einsum("bik,bik->bk", Vj, Vt))
    np.testing.assert_allclose(dots, 1.0, atol=1e-4)
    B = g.normal(size=(32, 12, 9)).astype(np.float32)
    B = B.transpose(0, 2, 1) @ B
    vj = np.asarray(jeig.smallest_eigvec_sym(jnp.asarray(B)))
    vt = teig.smallest_eigvec_sym(_t(B)).numpy()
    np.testing.assert_allclose(np.abs((vj * vt).sum(-1)), 1.0, atol=1e-4)


def test_epipolar_blocks_match_reference(matches):
    n1, n2, mv, _, _ = matches
    w = mv.astype(np.float32)
    Ej = np.stack([np.asarray(jepi.eight_point(jnp.asarray(a), jnp.asarray(b),
                                               weights=jnp.asarray(c)))
                   for a, b, c in zip(n1, n2, w)])
    Et = tepi.eight_point(_t(n1), _t(n2), weights=_t(w))
    _assert_E_close(Ej, Et.numpy())
    Pj = np.asarray(jepi.project_to_essential(jnp.asarray(Ej))[0])
    Pt = tepi.project_to_essential(_t(Ej))[0].numpy()
    np.testing.assert_allclose(Pt, Pj, atol=1e-5)
    dj = np.stack([np.asarray(jepi.sampson_error_sq(jnp.asarray(e),
                                                    jnp.asarray(a),
                                                    jnp.asarray(b)))
                   for e, a, b in zip(Pj, n1, n2)])
    dt = tepi.sampson_error_sq(_t(Pj), _t(n1), _t(n2)).numpy()
    np.testing.assert_allclose(dt, dj, rtol=1e-4, atol=1e-12)


def _jax_ransac(matches, degensac, num_hypotheses=128, pairs=None,
                solver="5pt"):
    n1, n2, mv, thr, keys = matches
    out = []
    for i in (range(len(PAIRS)) if pairs is None else pairs):
        r = jran.ransac_essential(jnp.asarray(keys[i]), jnp.asarray(n1[i]),
                                  jnp.asarray(n2[i]), jnp.asarray(mv[i]),
                                  thr[i], num_hypotheses=num_hypotheses,
                                  solver=solver, degensac=degensac)
        out.append({k: np.asarray(v) for k, v in r.items()})
    return {k: np.stack([o[k] for o in out]) for k in out[0]}


@pytest.mark.parametrize("degensac", [False, True])
def test_ransac_essential_matches_reference(matches, degensac):
    n1, n2, mv, thr, keys = matches
    sel = [1, 2] if degensac else [0, 1, 2]
    ref = _jax_ransac(matches, degensac, pairs=sel)
    got = tran.ransac_essential(convert.keys_from_numpy(keys[sel]),
                                _t(n1[sel]), _t(n2[sel]), _t(mv[sel]),
                                _t(thr[sel]), num_hypotheses=128,
                                solver="5pt", degensac=degensac)
    np.testing.assert_array_equal(ref["ok"], got["ok"].numpy())
    np.testing.assert_array_equal(ref["inlier_mask"],
                                  got["inlier_mask"].numpy())
    np.testing.assert_array_equal(ref["num_inliers"],
                                  got["num_inliers"].numpy())
    _assert_E_close(ref["E"], got["E"].numpy())


@pytest.mark.parametrize("degensac", [False, True])
def test_ransac_essential_8pt_matches_reference(matches, degensac):
    """The 8-point solver (the KITTI runner's --solver 8pt) with its refit
    rounds, on the same matches and keys, held to the 5-point test's exact
    contract on the two clean pairs. Pair 150->165 is left out in both
    modes: a few of its 128 minimal 8-point solves (ill-conditioned
    samples, e.g. a match drawn twice) differ in float32 by up to 0.02 in
    E, as a few in every pair do, and on this flat-likelihood pair one of
    them changes the winner (129 against 132 inliers); ROADMAP.md, Known
    divergences."""
    n1, n2, mv, thr, keys = matches
    sel = [1, 2]
    ref = _jax_ransac(matches, degensac, pairs=sel, solver="8pt")
    got = tran.ransac_essential(convert.keys_from_numpy(keys[sel]),
                                _t(n1[sel]), _t(n2[sel]), _t(mv[sel]),
                                _t(thr[sel]), num_hypotheses=128,
                                solver="8pt", degensac=degensac)
    assert ref["ok"].all()
    np.testing.assert_array_equal(ref["ok"], got["ok"].numpy())
    np.testing.assert_array_equal(ref["inlier_mask"],
                                  got["inlier_mask"].numpy())
    np.testing.assert_array_equal(ref["num_inliers"],
                                  got["num_inliers"].numpy())
    _assert_E_close(ref["E"], got["E"].numpy())


def test_recover_pose_matches_reference(matches):
    n1, n2, mv, _, _ = matches
    ref = _jax_ransac(matches, degensac=False)
    out_j = [jrp.recover_pose(jnp.asarray(e), jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(v), inlier_mask=jnp.asarray(m))
             for e, a, b, v, m in zip(ref["E"], n1, n2, mv,
                                      ref["inlier_mask"])]
    R, t, votes, good = trp.recover_pose(_t(ref["E"]), _t(n1), _t(n2),
                                         _t(mv), inlier_mask=_t(
                                             ref["inlier_mask"]))
    for i, (Rj, tj, vj, gj) in enumerate(out_j):
        np.testing.assert_allclose(R[i].numpy(), np.asarray(Rj), atol=1e-5)
        np.testing.assert_allclose(t[i].numpy(), np.asarray(tj), atol=1e-5)
        assert int(votes[i]) == int(vj)
        np.testing.assert_array_equal(good[i].numpy(), np.asarray(gj))
    # the per-hypothesis cheirality vote used by RANSAC's re-rank
    vj = [int(jrp.cheirality_votes(jnp.asarray(e), jnp.asarray(a),
                                   jnp.asarray(b), jnp.asarray(m)))
          for e, a, b, m in zip(ref["E"], n1, n2, ref["inlier_mask"])]
    vt = trp.cheirality_votes(_t(ref["E"]), _t(n1), _t(n2),
                              _t(ref["inlier_mask"]))
    assert vt.tolist() == vj


def test_degensac_rescue_matches_reference(matches):
    n1, n2, mv, thr, keys = matches
    ref = _jax_ransac(matches, degensac=False)
    kd = np.asarray(jax.vmap(lambda k: jax.random.fold_in(k, 7))(keys))
    out_j = [[np.asarray(x) for x in jhom.degensac_rescue(
        jnp.asarray(kd[i]), jnp.asarray(ref["E"][i]),
        jnp.asarray(ref["inlier_mask"][i]), jnp.asarray(ref["num_inliers"][i]),
        jnp.asarray(n1[i]), jnp.asarray(n2[i]), jnp.asarray(mv[i]), thr[i])]
        for i in range(len(PAIRS))]
    E, mask, n_in, used, h_cnt = thom.degensac_rescue(
        convert.keys_from_numpy(kd), _t(ref["E"]), _t(ref["inlier_mask"]),
        _t(ref["num_inliers"]), _t(n1), _t(n2), _t(mv), _t(thr))
    for i, (Ej, mj, nj, uj, hj) in enumerate(out_j):
        _assert_E_close(Ej[None], E[i:i + 1].numpy())
        np.testing.assert_array_equal(mask[i].numpy(), mj)
        assert int(n_in[i]) == int(nj) and bool(used[i]) == bool(uj)
        assert int(h_cnt[i]) == int(hj)


def test_ambiguity_blend_matches_reference(matches):
    """The blend on the reference's own hypothesis batch (5-point roots of
    64 minimal samples per pair, scored as ransac_essential scores them)."""
    n1, n2, mv, thr, keys = matches

    @jax.jit
    def hypotheses(key, a, b, v, t):
        idx = jran.sample_minimal_indices(key, v, 64, 5)
        E_r, ok = five_point_essential(a[idx], b[idx])
        E_h = jepi.project_to_essential(E_r.reshape(-1, 3, 3))[0]
        d2 = jepi.sampson_error_sq(E_h, a[None], b[None])
        inl = (d2 < t * t) & v[None] & ok.reshape(-1)[:, None]
        counts = jnp.sum(inl.astype(jnp.int32), -1)
        trunc = jnp.sum(jnp.minimum(d2, t * t) * v[None], -1)
        score = counts * E_h.shape[0] - jnp.argsort(jnp.argsort(trunc))
        best = jnp.argmax(score)
        return E_h, score, counts, inl, E_h[best], inl[best], counts[best]

    ins = [[np.asarray(x) for x in hypotheses(
        jnp.asarray(keys[i]), jnp.asarray(n1[i]), jnp.asarray(n2[i]),
        jnp.asarray(mv[i]), thr[i])] for i in range(len(PAIRS))]
    st = [np.stack([x[k] for x in ins]) for k in range(7)]
    blend = jax.jit(jamb.ambiguity_blend)
    out_j = [[np.asarray(y) for y in blend(
        *(jnp.asarray(x[k]) for k in range(4)), jnp.asarray(n1[i]),
        jnp.asarray(n2[i]), jnp.asarray(mv[i]), thr[i],
        *(jnp.asarray(x[k]) for k in range(4, 7)))]
        for i, x in enumerate(ins)]
    E, mask, n_out, fired = tamb.ambiguity_blend(
        _t(st[0]), _t(st[1]), _t(st[2]), _t(st[3]), _t(n1), _t(n2), _t(mv),
        _t(thr), _t(st[4]), _t(st[5]), _t(st[6]))
    assert bool(fired.any())
    for i, (Ej, mj, nj, fj) in enumerate(out_j):
        assert bool(fired[i]) == bool(fj)
        _assert_E_close(Ej[None], E[i:i + 1].numpy(),
                        atol=1e-3 if bool(fj) else 1e-4)
        np.testing.assert_array_equal(mask[i].numpy(), mj)
        assert int(n_out[i]) == int(nj)
