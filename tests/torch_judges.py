"""The contracts that hold the port's fixed-order kernels P1
(csrc/five_point_coeffs.cu), P2 (csrc/fixed_order.cu), P3 and P4
(csrc/sift_sample.cu) to their plain versions and to a float64 run,
shared by chip_smoke.py and tests/test_torch_gpu.py:

    from torch_judges import p1_judge, p2_judge, p2_serial, p3_judge, \
        p3_serial, p4_judge

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


def p2_serial(a, b=None, a2=None):
    """P2's serial reference: every output f32(sum over k ascending of
    f64(a) f64(b)), by a loop over k in float64 (a product of two float32
    values is exact in float64, so each step rounds once, as the kernel's
    fma does). a (..., m, k) @ b (..., k, n) with batch dimensions
    broadcast; b None: the row sums of a (..., k); a2 given: the chain
    a @ f32(a2 @ b). Bit for bit what P2 gives at any batch."""
    if a2 is not None:
        return p2_serial(a, p2_serial(a2, b))
    x = a.double()
    if b is None:
        acc = torch.zeros(x.shape[:-1], dtype=torch.float64, device=x.device)
        for q in range(x.shape[-1]):
            acc = acc + x[..., q]
        return acc.float()
    y = b.double()
    shape = torch.broadcast_shapes(x.shape[:-2], y.shape[:-2]) + (
        x.shape[-2], y.shape[-1])
    acc = torch.zeros(shape, dtype=torch.float64, device=x.device)
    for q in range(x.shape[-1]):
        acc = acc + x[..., :, q:q + 1] * y[..., q:q + 1, :]
    return acc.float()


def p3_serial(vx, vy, bins):
    """P3's serial reference on the kernel's own detail outputs: samples
    vx, vy (..., 24, 24) and bins (..., 576). Each term is formed in
    float32 as the kernel forms it, sqrt(vx * vx + vy * vy) times the
    window, one rounding a step (no fused multiply-add); each bin is the
    float64 sum of its terms in ascending sample order, rounded once to
    float32. Returns (..., 36): bit for bit what P3 gives at any batch."""
    from rpe_tpu_torch.ops import sift

    lead = bins.shape[:-1]
    n = bins.numel() // bins.shape[-1]
    vx, vy = vx.reshape(n, -1), vy.reshape(n, -1)
    ori_w = sift._grid_weights()[0].reshape(-1).to(vx.device)
    xx, yy = vx * vx, vy * vy
    terms = torch.sqrt(xx + yy) * ori_w
    b = bins.reshape(n, -1).long()
    acc = torch.zeros(n, 36, dtype=torch.float64, device=vx.device)
    for s in range(b.shape[1]):
        acc.scatter_add_(1, b[:, s:s + 1], terms[:, s:s + 1].double())
    return acc.float().reshape(*lead, 36)


def p3_references(gxp, gyp, ucx, ucy, scl):
    """What P3 is held to on its inputs: the plain version's histogram
    and, per sample, its bins and terms (`_orientation_terms`) in float32
    and in a float64 run, and each sample's magnitude taken through the
    sampling (its |taps| summed, as P2's sum |a| |b|, times the window):
    a bound on its term in any order of the sums. The float64 run takes
    the plain version's sample weights (its float32 steps, which the
    kernel repeats) and carries every product, sum and bin after them in
    float64; its histogram is the float64 sum of its terms. Returns
    (hist_p, bins_p, w_p, hist_d, bins_d, w_d, m_abs): the histograms
    (N, 36), the rest (N, 576), N = F * Q."""
    from rpe_tpu_torch.ops import sift

    hist_p = sift.orientation_hist_plain(gxp, gyp, ucx, ucy, scl)
    n = hist_p.numel() // hist_p.shape[-1]
    bins_p, w_p = sift._orientation_terms(*sift._orientation_samples(
        gxp, gyp, ucx, ucy, scl))
    Wy, Wx = (w.double() for w in sift._orientation_weights(
        ucx, ucy, scl, *gxp.shape[-2:]))
    bins_d, w_d = sift._orientation_terms(*(
        sift._patch_sample(g.double(), Wy, Wx) for g in (gxp, gyp)))
    _, m_abs = sift._orientation_terms(*(
        sift._patch_sample(g.double().abs(), Wy, Wx) for g in (gxp, gyp)))
    bins_p, w_p, bins_d, w_d, m_abs = (x.reshape(n, -1) for x in (
        bins_p, w_p, bins_d, w_d, m_abs))
    return (hist_p.reshape(n, -1), bins_p, w_p, _bin_sums(bins_d, w_d),
            bins_d, w_d, m_abs)


def _bin_sums(bins, w, mask=None):
    """Float64 sums of the terms w (N, S) by bin (N, S) over 36 bins."""
    x = w.double() if mask is None else w.double() * mask
    return torch.zeros(bins.shape[0], 36, dtype=torch.float64,
                       device=w.device).scatter_add_(1, bins.long(), x)


def p3_judge(hist_k, bins_k, refs):
    """P3's histogram hist_k and its samples' bins bins_k (the kernel's
    own, from its detail outputs) against `p3_references`. Each bin's
    scale is the sum of its samples' magnitudes (m_abs). A slot is
    flipped against a reference where a sample that can move a
    histogram (m_abs > 0) has another bin there: its angle lies within
    rounding of a bin edge (in the float64 run also where the float32 bin
    arithmetic rounds onto the edge). Slots flipped against neither are
    held as P2 is (`p2_judge`); a flipped slot may differ from that
    reference by no more than 1e-6 of the scale plus its flipped samples'
    magnitudes in the bins they left and entered. Slots flipped against
    the plain version: at most one per 1000 (rounded up). Returns (ok,
    numbers for the report)."""
    hist_p, bins_p, w_p, hist_d, bins_d, w_d, m_abs = refs
    n = hist_k.reshape(-1, 36).shape[0]
    k = hist_k.reshape(n, 36)
    bk = bins_k.reshape(n, -1).long()
    scale = _bin_sums(bins_d, m_abs)
    flips, bounded = {}, True
    for name, h, b in (("plain", hist_p, bins_p), ("float64", hist_d,
                                                     bins_d)):
        moved = (bk != b) & (m_abs > 0)
        flips[name] = moved.any(-1)
        slack = _bin_sums(b, m_abs, moved) + _bin_sums(bk, m_abs, moved)
        err = (k.double() - h.double()).abs()
        bounded &= bool((err <= 1e-6 * scale + slack)[flips[name]].all())
    keep = ~(flips["plain"] | flips["float64"])
    ok_p2, rel_kd, rel_kp, rel_pd = p2_judge(k[keep], hist_p[keep],
                                             hist_d[keep], scale[keep])
    cap = -(-n // 1000)
    n_p, n_d = int(flips["plain"].sum()), int(flips["float64"].sum())
    finite = bool(torch.isfinite(k).all())
    ok = ok_p2 and bounded and n_p <= cap and finite
    return ok, dict(slots=n, flipped_plain=n_p, flipped_f64=n_d, cap=cap,
                    rel_kernel_f64=rel_kd, rel_kernel_plain=rel_kp,
                    rel_plain_f64=rel_pd, flipped_within_bound=bounded,
                    finite=finite)


def p4_judge(desc_k, desc_p, desc_d):
    """P4's descriptors against the plain version's and its float64 run:
    finite, and within 1e-5 of both on every slot (the trilinear weights
    are continuous across bin edges, so no slot is exempt). Returns (ok,
    max |k - p|, max |k - f64|, max |p - f64|)."""
    k = desc_k.double()
    e_kp = float((k - desc_p.double()).abs().max()) if k.numel() else 0.0
    e_kd = float((k - desc_d).abs().max()) if k.numel() else 0.0
    e_pd = float((desc_p.double() - desc_d).abs().max()) if k.numel() else 0.0
    ok = bool(torch.isfinite(desc_k).all()) and e_kp <= 1e-5 and e_kd <= 1e-5
    return ok, e_kp, e_kd, e_pd


# P5-P8 (csrc/small_solvers.cu): launch counter -> (module, public function,
# plain version); geometry/homography.py binds `smallest_eigvec_sym` too
SMALL_SOLVERS = {
    "smallest_eigvec_sym": ("rpe_tpu_torch.geometry.eig",
                            "smallest_eigvec_sym",
                            "smallest_eigvec_sym_plain"),
    "eigh3x3_desc": ("rpe_tpu_torch.geometry.eig", "eigh3x3_desc",
                     "eigh3x3_desc_plain"),
    "essential_frame": ("rpe_tpu_torch.geometry.epipolar",
                        "frame_rotations", "frame_rotations_plain"),
    "threefry2x32": ("rpe_tpu_torch.rng", "threefry2x32",
                     "threefry2x32_plain"),
}


def _small_solver_sites():
    """(module, attribute, launch counter) of every binding the estimator
    calls P5-P8 through."""
    import importlib

    sites = [(importlib.import_module(m), f, k)
             for k, (m, f, _) in SMALL_SOLVERS.items()]
    homography = importlib.import_module("rpe_tpu_torch.geometry.homography")
    return sites + [(homography, "smallest_eigvec_sym", "smallest_eigvec_sym")]


def small_solvers_patched(wrap):
    """A context manager that replaces every binding of P5-P8's public
    functions by `wrap(name, fn)` (fn the public function, name its launch
    counter) and restores them."""
    import contextlib

    @contextlib.contextmanager
    def patched():
        sites = _small_solver_sites()
        saved = [(m, f, getattr(m, f)) for m, f, _ in sites]
        try:
            for m, f, k in sites:
                setattr(m, f, wrap(k, getattr(m, f)))
            yield
        finally:
            for m, f, fn in saved:
                setattr(m, f, fn)
    return patched()


def plain_small_solvers():
    """A context manager under which P5-P8's public functions run their
    plain versions on any device (the eager chains the kernels replace)."""
    import importlib

    def wrap(name, fn):
        m, _, plain = SMALL_SOLVERS[name]
        return getattr(importlib.import_module(m), plain)
    return small_solvers_patched(wrap)


def same_bits(a, b):
    """Equal shapes, dtypes and bits, a NaN where the other has a NaN (of
    any payload)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.dtype.is_floating_point:
        return bool(torch.equal(a, b))
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and bool(torch.equal(
        torch.where(nan, 0.0, a).view(torch.int32),
        torch.where(nan, 0.0, b).view(torch.int32)))
