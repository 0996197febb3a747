"""The contracts that hold the port's fixed-order kernels P1
(csrc/five_point_coeffs.cu) and P2 (csrc/fixed_order.cu) to their plain
versions and to a float64 run, shared by chip_smoke.py and
tests/test_torch_gpu.py:

    from torch_judges import p1_judge, p2_judge

Only torch is needed, so chip_smoke.py can import this file on the card
machine.
"""

import torch


def p1_judge(c_k, c_p, c_d):
    """P1's coefficients c_k against the plain version's c_p and its
    float64 run c_d, each (..., 10, 20). Per hypothesis: within 1e-5 of
    the float64 run; within 1e-5 of the plain version wherever the plain
    float32 coefficients are themselves within 1e-5 of the float64 run
    (elsewhere -- samples that repeat a point, ill-conditioned ones -- the
    plain float32 order is no reference); and overall no further from the
    float64 run than the plain version + 1e-6. Returns (ok, max |k - p|
    where held to it, max |k - f64|, max |p - f64|, hypotheses where the
    plain is not within 1e-5 of f64)."""
    k = c_k.reshape(-1, 200).double()
    p = c_p.reshape(-1, 200).double()
    d = c_d.reshape(-1, 200)
    ek = (k - d).abs().amax(-1)
    ep = (p - d).abs().amax(-1)
    dkp = (k - p).abs().amax(-1)
    right = ep <= 1e-5
    held = float(dkp[right].max()) if bool(right.any()) else 0.0
    worst_k, worst_p = float(ek.max()), float(ep.max())
    ok = held <= 1e-5 and worst_k <= 1e-5 and worst_k <= worst_p + 1e-6
    return ok, held, worst_k, worst_p, int((~right).sum())


def p2_judge(got, want, exact, scale):
    """P2's result `got` against the plain float32 product `want`, the
    float64 product `exact` and scale = sum_k |a| |b| (float64), per
    element: within 1e-6 * scale of float64; and within 1e-6 * scale of
    the plain version wherever the plain version is itself that close to
    float64 (elsewhere -- its float32 sum over 500-1000 matches -- the
    plain order is no reference). A non-finite result must equal the
    plain one. Returns (ok, relative errors kernel-float64, kernel-plain,
    plain-float64)."""
    tol = 1e-6 * scale
    dk = (got.double() - exact).abs()
    dp = (want.double() - exact).abs()
    dkp = (got.double() - want.double()).abs()
    nonfinite = ~torch.isfinite(got) & (
        (got == want) | (torch.isnan(got) & torch.isnan(want)))
    fine = nonfinite | ((dk <= tol) & ((dkp <= tol) | (dp > tol)))
    s = scale.clamp_min(1e-300)

    def rel(x):
        return float(torch.nan_to_num(x / s, nan=0.0).max()) \
            if x.numel() else 0.0

    return bool(fine.all()), rel(dk), rel(dkp), rel(dp)
