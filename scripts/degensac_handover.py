#!/usr/bin/env python3
"""Stage-by-stage hand-over of one pair's RANSAC + DEGENSAC between the
reference (`rpe_tpu`) and the port (`rpe_tpu_torch`), on the CPU.

    JAX_PLATFORMS=cpu python3 scripts/degensac_handover.py   # ~1 min

The pair is the one of `scripts/pose_parity_probe.py` where the two
packages end furthest apart: the ORB Hamming ratio test with DEGENSAC,
keys (10, 11), pair 1 (key 11). Both packages get the same normalised
points, mask and threshold (the port's matches, which equal the
reference's). Each package's stage functions are wrapped to record what
they are given and what they return; the reference runs un-jitted so the
records are concrete. Stages, in order:

  1. the minimal samples (threefry draws);
  2. the 5-point roots on those samples: the null space and constraint
     coefficients, then the port's root finder handed the reference's
     coefficients, with a float64 solve as the arbiter;
  3. the scoring, selection and refits that feed DEGENSAC, with the port
     handed the reference's 5-point output;
  4. DEGENSAC (homography RANSAC, GRIC, plane-and-parallax) and the
     ambiguity blend, with the port handed the reference's inputs.

For each stage it prints whether the outputs agree exactly or how far
apart they are.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import rpe_tpu.config as jcfg  # noqa: E402
import rpe_tpu.geometry.ambiguity as j_amb  # noqa: E402
import rpe_tpu.geometry.five_point as j_fp  # noqa: E402
import rpe_tpu.geometry.homography as j_hom  # noqa: E402
from rpe_tpu.geometry import ransac as j_ransac  # noqa: E402
from rpe_tpu.pipeline import estimator as jest  # noqa: E402
import rpe_tpu_torch.geometry.ambiguity as t_amb  # noqa: E402
import rpe_tpu_torch.geometry.five_point as t_fp  # noqa: E402
import rpe_tpu_torch.geometry.homography as t_hom  # noqa: E402
from rpe_tpu_torch import convert  # noqa: E402
from rpe_tpu_torch.geometry import ransac as t_ransac  # noqa: E402
from rpe_tpu_torch.geometry.epipolar import normalize_points  # noqa: E402
from rpe_tpu_torch.pipeline import estimator as test_  # noqa: E402
from rpe_tpu_torch.utils.synthetic import make_sequence  # noqa: E402

PAIR = 1          # key 11 of the keys (10, 11)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _unit(E):
    E = np.asarray(E, np.float64)
    return E / np.linalg.norm(E, axis=(-2, -1), keepdims=True)


def _e_gap(Ea, Eb):
    """Largest entry difference of unit-norm, sign-aligned essentials."""
    a, b = _unit(Ea), _unit(Eb)
    s = np.sign((a * b).sum((-2, -1)))[..., None, None]
    return float(np.nanmax(np.abs(a - s * b)))


class Recorder:
    """Wraps module-level functions; records (args, result) per call and,
    when `replace` holds a value for the name, returns it instead."""

    def __init__(self):
        self.calls, self.replace, self._orig = {}, {}, []

    def wrap(self, module, name):
        orig = getattr(module, name)
        self._orig.append((module, name, orig))

        def f(*args, **kw):
            out = self.replace.get(name)
            if out is None:
                out = orig(*args, **kw)
            self.calls.setdefault(name, []).append((args, kw, out))
            return out
        setattr(module, name, f)

    def restore(self):
        for module, name, orig in self._orig:
            setattr(module, name, orig)


def pair_inputs():
    """The pair's normalised points, mask and threshold, and both keys."""
    jc = jcfg.EstimatorConfig(
        orb=jcfg.OrbConfig(nfeatures=256, nlevels=4, max_kpts=256),
        ransac=jcfg.RansacConfig(num_hypotheses=64),
        matcher=jcfg.MatcherConfig(cross_check=False, max_matches=128))
    frames, K, _ = make_sequence(3, 160, 320, seed=1)
    stack = {k: np.asarray(v) for k, v in jax.jit(lambda ims: jax.lax.map(
        lambda im: jest.detect_features(im, jc), ims))(
            jnp.asarray(frames)).items()}
    td = convert.detections_from_numpy(stack)
    tc = convert.config_from_dict(dataclasses.asdict(jc))
    keys = np.asarray(jax.vmap(jax.random.PRNGKey)(np.arange(2) + 10))
    got = test_._match_to_pose({k: v[:-1] for k, v in td.items()},
                               {k: v[1:] for k, v in td.items()},
                               torch.from_numpy(K),
                               convert.keys_from_numpy(keys), tc)
    n1 = normalize_points(got["pts1"], torch.from_numpy(K))[PAIR]
    n2 = normalize_points(got["pts2"], torch.from_numpy(K))[PAIR]
    mask = got["match_valid"][PAIR]
    thr = np.float32(jc.ransac.threshold_px / (0.5 * (K[0, 0] + K[1, 1])))
    kw = dict(num_hypotheses=jc.ransac.num_hypotheses,
              refit_rounds=jc.ransac.refit_rounds, solver=jc.ransac.solver,
              degensac=jc.ransac.degensac)
    return n1, n2, mask, thr, keys[PAIR], kw


def run_ref(n1, n2, mask, thr, key, kw):
    with jax.default_matmul_precision("highest"):
        return j_ransac.ransac_essential.__wrapped__(
            jnp.asarray(key), jnp.asarray(n1.numpy()), jnp.asarray(n2.numpy()),
            jnp.asarray(mask.numpy()), jnp.float32(thr), **kw)


def run_port(n1, n2, mask, thr, key, kw):
    return t_ransac.ransac_essential(
        convert.keys_from_numpy(key[None]), n1[None], n2[None], mask[None],
        torch.full((1,), float(thr)), **kw)


def main():
    jax.config.update("jax_platforms", "cpu")
    n1, n2, mask, thr, key, kw = pair_inputs()
    print(f"pair {PAIR} of keys (10, 11): {int(mask.sum())} valid matches, "
          f"threshold {thr:.6e}, {kw}")

    jr, tr = Recorder(), Recorder()
    for rec, fp, hom, amb in ((jr, j_fp, j_hom, j_amb),
                              (tr, t_fp, t_hom, t_amb)):
        rec.wrap(fp, "five_point_essential")
        rec.wrap(hom, "degensac_rescue")
        rec.wrap(hom, "ransac_homography")
        rec.wrap(hom, "plane_parallax_essentials")
        rec.wrap(amb, "ambiguity_blend")
    try:
        ref = run_ref(n1, n2, mask, thr, key, kw)
        got = run_port(n1, n2, mask, thr, key, kw)
        print(f"0. as run: inliers ref {int(ref['num_inliers'])} port "
              f"{int(got['num_inliers'][0])}, |dE| "
              f"{_e_gap(_np(ref['E']), _np(got['E'][0])):.3e}")

        # 1. samples: the 5-point solver's inputs
        (ja, _, (jE, jok)), = jr.calls["five_point_essential"]
        (ta, _, (tE, tok)), = tr.calls["five_point_essential"]
        same_pts = all(np.array_equal(_np(a), _np(b)[0])
                       for a, b in zip(ja, ta))
        print(f"1. samples (gathered points, {ja[0].shape}): identical "
              f"{same_pts}")

        # 2. the 5-point roots on identical samples
        jE, jok, tE, tok = _np(jE), _np(jok), _np(tE)[0], _np(tok)[0]
        both = jok & tok
        print(f"2. 5-point roots: root_ok identical {np.array_equal(jok, tok)}"
              f" ({int(jok.sum())} ref, {int(tok.sum())} port); on the "
              f"{int(both.sum())} roots both keep, max |dE| "
              f"{_e_gap(jE[both], tE[both]):.3e}")


        # what fed DEGENSAC on each side as run
        (jd, _, jd_out), = jr.calls["degensac_rescue"]
        (td, _, td_out), = tr.calls["degensac_rescue"]
        print(f"   as run, into DEGENSAC: inliers ref {int(_np(jd[3]))} port "
              f"{int(_np(td[3])[0])}, masks identical "
              f"{np.array_equal(_np(jd[2]), _np(td[2])[0])}, |dE| "
              f"{_e_gap(_np(jd[1]), _np(td[1])[0]):.3e}; rescue used: ref "
              f"{bool(_np(jd_out[3]))} port {bool(_np(td_out[3])[0])}")
        (ja_, _, _), = jr.calls["ambiguity_blend"]
        (ta_, _, _), = tr.calls["ambiguity_blend"]
        jsc, tsc = _np(ja_[1]), _np(ta_[1])[0]
        jcnt, tcnt = _np(ja_[2]), _np(ta_[2])[0]
        print(f"   hypothesis counts identical {np.array_equal(jcnt, tcnt)} "
              f"(differ on {int((jcnt != tcnt).sum())} of {jcnt.size}), "
              f"scores identical {np.array_equal(jsc, tsc)}; best score "
              f"ref {int(jsc.max())} at {int(jsc.argmax())}, port "
              f"{int(tsc.max())} at {int(tsc.argmax())}")
        five_point_stage(ja, jE, jok, tE, jcnt, tcnt)

        # 3. the port handed the reference's 5-point output
        tr.calls.clear()
        E_in = torch.from_numpy(np.asarray(jE))[None]
        ok_in = torch.from_numpy(np.asarray(jok))[None]
        tr.replace["five_point_essential"] = (E_in, ok_in)
        got3 = run_port(n1, n2, mask, thr, key, kw)
        tr.replace.clear()
        (td3, _, td3_out), = tr.calls["degensac_rescue"]
        print(f"3. port given the reference's 5-point output: into DEGENSAC "
              f"inliers {int(_np(td3[3])[0])} (ref {int(_np(jd[3]))}), masks "
              f"identical {np.array_equal(_np(jd[2]), _np(td3[2])[0])}, |dE| "
              f"{_e_gap(_np(jd[1]), _np(td3[1])[0]):.3e}; rescue used "
              f"{bool(_np(td3_out[3])[0])} (ref {bool(_np(jd_out[3]))}); "
              f"final inliers {int(got3['num_inliers'][0])} (ref "
              f"{int(ref['num_inliers'])}), |dE| "
              f"{_e_gap(_np(ref['E']), _np(got3['E'][0])):.3e}")

        # 4. DEGENSAC alone on the reference's inputs
        tr.calls.clear()
        targs = [torch.from_numpy(np.asarray(_np(a)))[None]
                 if i != 0 else convert.keys_from_numpy(_np(a)[None])
                 for i, a in enumerate(jd)]
        targs[7] = torch.full((1,), float(thr))
        out4 = t_hom.degensac_rescue(*targs)
        (jh, _, (jH, jhm, jhc)), = jr.calls["ransac_homography"]
        (_, _, (tH, thm, thc)), = tr.calls["ransac_homography"]
        print(f"4. DEGENSAC on the reference's inputs: homography inliers "
              f"ref {int(_np(jhc))} port {int(_np(thc)[0])}, masks identical "
              f"{np.array_equal(_np(jhm), _np(thm)[0])}, |dH| "
              f"{_e_gap(_np(jH), _np(tH)[0]):.3e}; rescue used port "
              f"{bool(_np(out4[3])[0])} ref {bool(_np(jd_out[3]))}; inliers "
              f"port {int(_np(out4[2])[0])} ref {int(_np(jd_out[2]))}; |dE| "
              f"{_e_gap(_np(jd_out[0]), _np(out4[0])[0]):.3e}")
    finally:
        jr.restore()
        tr.restore()


def five_point_stage(ja, jE, jok, tE, jcnt, tcnt):
    """Inside the 5-point solver: the null space and constraint
    coefficients of both packages on identical samples, then the port's
    root finder handed the reference's coefficients, each root held to a
    float64 solve of the same coefficients (a root more than 1e-3 from
    every float64 root did not converge in float32)."""
    from rpe_tpu.geometry.epipolar import _build_epipolar_rows

    p1, p2 = (jnp.asarray(_np(a)) for a in ja)
    A = _build_epipolar_rows(p1, p2)
    nj = np.asarray(j_fp._householder_null4(A))
    cj = j_fp._build_constraint_coeffs(jnp.asarray(nj))
    cj = np.asarray(cj / jnp.sqrt(jnp.sum(cj * cj, -1, keepdims=True)
                                  + j_fp._EPS))
    nt, ct = t_fp.constraint_coeffs(torch.from_numpy(np.asarray(p1)),
                                    torch.from_numpy(np.asarray(p2)))
    nt, ct = nt.numpy(), ct.numpy()
    # a sample that draws one match twice has a rank-4 A: its null space
    # has 5 dimensions and rounding picks the 4 the solver gets
    rep = np.array([len({tuple(r) for r in np.asarray(s)}) < 5 for s in p1])
    proj = np.abs(nj @ nj.transpose(0, 2, 1)
                  - nt @ nt.transpose(0, 2, 1)).max(axis=(1, 2))
    rel = (np.abs(cj - ct).max(axis=(1, 2)) / np.abs(cj).max(axis=(1, 2)))
    print(f"   samples drawing a match twice (rank-4 A): "
          f"{np.nonzero(rep)[0].tolist()}; null-space projectors differ by up "
          f"to {proj[rep].max():.3e} there, {proj[~rep].max():.3e} elsewhere;"
          f" constraint coefficients elsewhere within {rel[~rep].max():.3e} "
          f"(relative)")

    def solve(C, N, dtype):
        C, N = (torch.from_numpy(np.asarray(a)).to(dtype) for a in (C, N))
        return [x.numpy() for x in t_fp._assemble_candidates(
            N, *t_fp.solve_roots_plain(C))]

    Ehand, okhand = solve(cj, nj, torch.float32)
    E64, ok64 = solve(cj, nj, torch.float64)

    def to64(E, h):
        s = h // 10
        return min((_e_gap(E, E64[s, q]) for q in range(10) if ok64[s, q]),
                   default=float("nan"))

    far = [h for h in range(jE.size // 9)
           if not rep[h // 10] and jok.reshape(-1)[h]
           and _e_gap(Ehand.reshape(-1, 3, 3)[h], jE.reshape(-1, 3, 3)[h])
           > 1e-3]
    print(f"   port given the reference's coefficients: root_ok identical "
          f"{np.array_equal(okhand, jok)}; roots of the other samples whose E "
          f"differs by > 1e-3: {far}")
    for h in far:
        print(f"     hypothesis {h}: gap to the nearest float64 root: ref "
              f"{to64(jE.reshape(-1, 3, 3)[h], h):.2e}, port given the "
              f"reference's coefficients "
              f"{to64(Ehand.reshape(-1, 3, 3)[h], h):.2e}")
    for lab, cnt in (("reference", jcnt), ("port", tcnt)):
        for h in np.nonzero(cnt == cnt.max())[0]:
            print(f"   top count of the {lab} as run: hypothesis {h} (sample "
                  f"{h // 10}{', repeated draw' if rep[h // 10] else ''}): "
                  f"count ref {int(jcnt[h])} port {int(tcnt[h])}; gap to the "
                  f"nearest float64 root: ref {to64(jE.reshape(-1, 3, 3)[h], h):.2e}"
                  f", port as run {to64(tE.reshape(-1, 3, 3)[h], h):.2e}, port "
                  f"given the reference's coefficients "
                  f"{to64(Ehand.reshape(-1, 3, 3)[h], h):.2e}")


if __name__ == "__main__":
    main()
