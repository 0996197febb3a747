"""Plain reference of SIFT detection (the sift configuration), float64, and
the configuration's whole check: detection, matching, pose.

The semantics are those the port states for its SIFT (ops/sift.py, the
reference's algorithm with OpenCV's defaults): the frame over 255, upsampled
2x by linear interpolation at half-pixel centres, blurred to sigma 1.6 (the
input taken as blurred by 0.5 px, 1.0 after the upsample); per octave S + 3
Gaussian layers by incremental separable blurs (taps to 4 sigma, reflected
edges), the next octave every second pixel of layer S, down to 32 px; DoG by
subtraction; a keypoint's quadratic offset -H^-1 g from the finite
differences at its integer sample; its scale 1.6 x 2^(layer / S); its
orientation the peak of a 36-bin histogram of gradient magnitudes over a
24 x 24 grid of bilinear samples within 4.5 scales, weighted by
exp(-4.5 r^2), smoothed by [1, 4, 6, 4, 1] / 16, the peak refined by a
parabola; its descriptor the 4 x 4 x 8 trilinear histogram of a 24 x 24 grid
over the rotated window of half-width 3 scales x sqrt(2) x 5 / 2, weighted by
exp(-(x^2 + y^2) 25 / 16), normalised, clipped at 0.2 and renormalised.
Gradients are central differences on the keypoint's own layer; samples lie
within an 80-px patch around the rounded keypoint, clamped into the image,
and are clamped 1 px inside it.

Which samples become keypoints: per octave, the samples of layers 1..S at
least 5 px inside that are strict extrema of their 26 neighbours with |D|
past 0.5 x 0.04 / S; of those the octave's quota (its share of the slots,
by area, at least 32) by |D|, the lowest index first among equal values;
each relocated by OpenCV's adjustLocalExtrema (up to 5 integer moves by the
rounded offset while any component is 0.5 or more; dropped where it leaves
layers 1..S or the border, where det H is 1e-12 or less, or where it does
not converge) and kept where |D + g.off / 2| x S >= 0.04 and, with the
layer's 2 x 2 Hessian, det > 0 and tr^2 x 10 < 11^2 det. The program's
selection (`select_candidates`' output) and its refined keypoints are held
to that on the reference's stacks:
  ext_gap       the widest margin (DoG) by which a selected sample is no
                extremum past the pre-threshold, or by which a sample left
                out that surely is one (by more than SURE_D) has a larger
                |D| than the weakest selected (than 0 where the octave did
                not fill its quota)
  test_gap      over the selected samples whose relocation the reference
                decides surely (every offset farther from a half-integer
                than float32 rounding of the stack can move it, det H away
                from its threshold): 1 where the program kept a keypoint
                that the reference drops, or moved it elsewhere; else the
                contrast or edge test's margin, relative, by which the
                program's keep or drop is wrong

What a keypoint is (its octave coordinates, continuous layer and integer
layer) the reference takes from the program's state at the timed path's
descriptor stage; it checks the state's source on its own terms, and the
program's output against the state:
  scale_gap     the widest |G - reference G| over the sampled frames' octave
                stacks (intensities over 255): the start
  refine_gap    the widest residual |H off + g| of the state's sub-sample
                offset in the reference's system at the same integer
                sample, in units of float32 rounding of the stack
                (`residual_roundings`): the stage the state comes from (an
                offset itself swings where H is near singular; its
                residual does not)
  kp_off        output keypoints whose position, angle or octave is not
                the state's (a count)
  ori_gap       the widest drop, as a share of the highest peak, of the
                reference's smoothed orientation histogram from its nearest
                peak to an output angle (`orientation_drop`)
  desc_gap      the widest L2 distance between an output descriptor and the
                reference's at the same keypoint and angle
Nothing here imports the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import matching, pose

F64 = torch.float64
S = 3
SIGMA0 = 1.6
BORDER = 5
PATCH = 80
GRID = 24
PRETHR = 0.5 * 0.04 / S
EDGE_R = 10.0
STEPS = 5
SURE_D = 2e-5
ROUNDING = 64 * 2.0 ** -23


def blur_taps(sigma: float) -> np.ndarray:
    ksize = int(2 * round(4.0 * sigma) + 1)
    x = np.arange(ksize, dtype=np.float64) - ksize // 2
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def blur(img, sigma: float):
    """Separable Gaussian of (H, W), rows first, reflected edges."""
    k = torch.tensor(blur_taps(sigma), dtype=img.dtype, device=img.device)
    r = k.shape[0] // 2
    h, w = img.shape
    x = torch.nn.functional.pad(img[None, None], (0, 0, r, r),
                                mode="reflect")[0, 0]
    acc = sum(x[t:t + h] * k[t] for t in range(k.shape[0]))
    x = torch.nn.functional.pad(acc[None, None], (r, r, 0, 0),
                                mode="reflect")[0, 0]
    return sum(x[:, t:t + w] * k[t] for t in range(k.shape[0]))


def upsample2x(img):
    """(H, W) -> (2H, 2W), linear at half-pixel centres, the edge samples
    copied."""
    def axis(n):
        s = (torch.arange(2 * n, dtype=F64) + 0.5) / 2.0 - 0.5
        j0 = torch.floor(s).long()
        f = s - j0
        w0, w1 = 1.0 - f, f.clone()
        j1 = j0 + 1
        w0[j0 < 0] = 0.0
        w1[j1 > n - 1] = 0.0
        tot = w0 + w1
        return (j0.clamp(0, n - 1), j1.clamp(0, n - 1), w0 / tot, w1 / tot)

    dt, dev = img.dtype, img.device
    j0, j1, w0, w1 = (t.to(dev) for t in axis(img.shape[0]))
    x = img[j0] * w0[:, None].to(dt) + img[j1] * w1[:, None].to(dt)
    j0, j1, w0, w1 = (t.to(dev) for t in axis(img.shape[1]))
    return x[:, j0] * w0.to(dt) + x[:, j1] * w1.to(dt)


def level_sigmas():
    k = 2.0 ** (1.0 / S)
    sig = [SIGMA0]
    for i in range(1, S + 3):
        prev = SIGMA0 * k ** (i - 1)
        sig.append(math.sqrt((prev * k) ** 2 - prev ** 2))
    return sig


def scale_space(frame, noctaves: int, dtype=F64):
    """The octave stacks (S + 3, h, w) of one frame."""
    x = upsample2x(frame.to(dtype) / 255.0)
    x = blur(x, math.sqrt(max(SIGMA0 ** 2 - 1.0, 0.01)))
    sig = level_sigmas()
    oh, ow = x.shape
    out = []
    for _ in range(noctaves):
        if oh < 32 or ow < 32:
            break
        g = [x]
        for i in range(1, S + 3):
            g.append(blur(g[-1], sig[i]))
        out.append(torch.stack(g))
        x = g[S][::2, ::2][:oh // 2, :ow // 2]
        oh, ow = oh // 2, ow // 2
    return out


def system(D, k, y, x, dtype=F64):
    """The Hessian H (K, 3, 3) and gradient g (K, 3) of DoG stack D
    (S + 2, h, w) at integer samples (k, y, x), by finite differences, in
    `dtype` (axes x, y, layer)."""
    def at(dk, dy, dx):
        return D[k + dk, y + dy, x + dx].to(dtype)

    c = at(0, 0, 0)
    g = torch.stack([(at(0, 0, 1) - at(0, 0, -1)) * 0.5,
                     (at(0, 1, 0) - at(0, -1, 0)) * 0.5,
                     (at(1, 0, 0) - at(-1, 0, 0)) * 0.5], -1)
    dxx = at(0, 0, 1) + at(0, 0, -1) - 2 * c
    dyy = at(0, 1, 0) + at(0, -1, 0) - 2 * c
    dss = at(1, 0, 0) + at(-1, 0, 0) - 2 * c
    dxy = (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1) + at(0, -1, -1)) * 0.25
    dxs = (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1) + at(-1, 0, -1)) * 0.25
    dys = (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0) + at(-1, -1, 0)) * 0.25
    H = torch.stack([torch.stack([dxx, dxy, dxs], -1),
                     torch.stack([dxy, dyy, dys], -1),
                     torch.stack([dxs, dys, dss], -1)], -2)
    return H, g


def offsets(D, k, y, x):
    """-H^-1 g at integer samples (k, y, x); 0 where H is singular."""
    H, g = system(D, k, y, x)
    ok = torch.linalg.det(H).abs() > 1e-300
    H = torch.where(ok[:, None, None], H, torch.eye(3, dtype=F64,
                                                    device=H.device))
    off = -torch.linalg.solve(H, g[..., None])[..., 0]
    return torch.where(ok[:, None], off, torch.zeros_like(off))


def residual_roundings(H, g, off, G, k, y, x):
    """|H off + g| (max norm) in units of what float32 rounding of the
    stack can leave in it: 2^-23 of the largest |G| in the sample's
    3 x 3 x 3 neighbourhood (layers k - 1 .. k + 2 of G), times
    4 |off|_1 + 1, the weight of one rounding in the finite differences.
    A well-computed offset reads a few units wherever H is near singular;
    an offset computed in bfloat16 reads tens of thousands."""
    r = ((H @ off[..., None])[..., 0] + g).abs().amax(-1)
    d = torch.arange(-1, 2, device=G.device)
    cube = G[(k[:, None] + torch.arange(-1, 3, device=G.device))[
        :, :, None, None], (y[:, None] + d)[:, None, :, None],
        (x[:, None] + d)[:, None, None, :]]
    scale = cube.abs().flatten(1).amax(1).to(F64) * 2.0 ** -23
    return r / (scale * (4 * off.abs().sum(-1) + 1))


def octave_quotas(max_kpts: int, noctaves: int):
    """Each octave's slots: max_kpts in proportion to its area, at least
    32, the largest trimmed until they fit."""
    wts = [4.0 ** (-o) for o in range(noctaves)]
    q = [max(int(round(max_kpts * x / sum(wts))), 32) for x in wts]
    while sum(q) > max_kpts:
        q[q.index(max(q))] -= 1
    return q


def extremum_margin(D):
    """(S, h, w): by how much each sample of layers 1..S of DoG stack D
    (S + 2, h, w) is a strict extremum of its 26 neighbours past the
    pre-threshold (> 0 iff it is one); -inf within BORDER of the edge."""
    n, h, w = D.shape
    c = D[:, 1:-1, 1:-1]
    rmax = torch.full_like(c, -math.inf)
    rmin = torch.full_like(c, math.inf)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                v = D[:, 1 + dy:h - 1 + dy, 1 + dx:w - 1 + dx]
                rmax = torch.maximum(rmax, v)
                rmin = torch.minimum(rmin, v)
    fmax, fmin = torch.maximum(rmax, c), torch.minimum(rmin, c)
    out = torch.full((n - 2, h, w), -math.inf, dtype=D.dtype,
                     device=D.device)
    for k in range(1, n - 1):
        d = c[k]
        nmax = torch.maximum(rmax[k], torch.maximum(fmax[k - 1], fmax[k + 1]))
        nmin = torch.minimum(rmin[k], torch.minimum(fmin[k - 1], fmin[k + 1]))
        out[k - 1, 1:-1, 1:-1] = torch.maximum(
            torch.minimum(d - nmax, d - PRETHR),
            torch.minimum(nmin - d, -PRETHR - d))
    out[:, :BORDER] = -math.inf
    out[:, h - BORDER:] = -math.inf
    out[:, :, :BORDER] = -math.inf
    out[:, :, w - BORDER:] = -math.inf
    return out


def _adjugate_solve(H, g):
    """-H^-1 g (N, 3) by the adjugate, H (N, 3, 3) symmetric, and det H."""
    a, e, i = H[:, 0, 0], H[:, 1, 1], H[:, 2, 2]
    b, c, f = H[:, 0, 1], H[:, 0, 2], H[:, 1, 2]
    det = a * (e * i - f * f) - b * (b * i - f * c) + c * (b * f - e * c)
    dd = torch.where(det.abs() > 1e-12, det, torch.ones_like(det))
    A = torch.stack([torch.stack([e * i - f * f, c * f - b * i,
                                  b * f - c * e], -1),
                     torch.stack([c * f - b * i, a * i - c * c,
                                  c * b - a * f], -1),
                     torch.stack([b * f - c * e, c * b - a * f,
                                  a * e - b * b], -1)], -2)
    off = -(A * g[:, None, :]).sum(-1) / dd[:, None]
    return off, det, A / dd[:, None, None]


def _system_at(D, k, y, x):
    """`system` at samples clamped into D (dropped samples read garbage)."""
    n, h, w = D.shape
    return system(D, k.clamp(1, n - 2), y.clamp(1, h - 2),
                  x.clamp(1, w - 2), D.dtype)


def relocate(D, k, y, x, gmax=None):
    """adjustLocalExtrema from integer samples (k, y, x) (N,) of DoG stack
    D (S + 2, h, w), in D's type: the final samples, offsets (N, 3),
    whether each is kept, its contrast and edge margins (relative) and,
    with `gmax` (the stack's largest |G|), whether every decision on the
    way was sure."""
    n, h, w = D.shape
    k, y, x = k.clone(), y.clone(), x.clone()
    N = k.shape[0]
    alive = torch.ones(N, dtype=torch.bool, device=D.device)
    conv = torch.zeros_like(alive)
    sure = torch.ones_like(alive)
    off = torch.zeros((N, 3), dtype=D.dtype, device=D.device)
    for _ in range(STEPS):
        H, g = _system_at(D, k, y, x)
        o, det, Hinv = _adjugate_solve(H, g)
        upd = alive & ~conv
        if gmax is not None:
            u = (Hinv.abs().sum(-1) * ROUNDING * gmax
                 * (1.0 + 4.0 * o.abs().sum(-1, keepdim=True)))
            edge = ((o - torch.floor(o)) - 0.5).abs() <= u
            near = (det.abs() > 0.5e-12) & (det.abs() < 2e-12)
            sure &= ~(upd & (edge.any(-1) | near))
        off = torch.where(upd[:, None], o, off)
        now = (o.abs() < 0.5).all(-1)
        conv |= upd & now
        mv = (upd & ~now)[:, None]
        step = torch.where(mv, torch.round(o), torch.zeros_like(o)).long()
        x, y, k = x + step[:, 0], y + step[:, 1], k + step[:, 2]
        alive &= ((k >= 1) & (k <= n - 2) & (x >= BORDER) & (x < w - BORDER)
                  & (y >= BORDER) & (y < h - BORDER) & (det.abs() > 1e-12))
    alive &= conv
    H, g = _system_at(D, k, y, x)
    ctr = D[k.clamp(1, n - 2), y.clamp(1, h - 2), x.clamp(1, w - 2)]
    dhat = ctr + 0.5 * (g * off).sum(-1)
    cm = (dhat.abs() * S - 0.04) / 0.04
    dxx, dyy, dxy = H[:, 0, 0], H[:, 1, 1], H[:, 0, 1]
    tr, dt = dxx + dyy, dxx * dyy - dxy * dxy
    em = (((EDGE_R + 1) ** 2 * dt - EDGE_R * tr * tr)
          / ((EDGE_R + 1) ** 2 * dt.abs() + EDGE_R * tr * tr + 1e-300))
    keep = alive & (cm >= 0) & (em > 0)
    return {"k": k, "y": y, "x": x, "off": off, "alive": alive,
            "keep": keep, "margin": torch.minimum(cm, em).to(F64),
            "sure": sure}


def selection_numbers(G, sel: dict, quota: int) -> dict:
    """ext_gap and test_gap of one octave: G the reference's stack
    (S + 3, h, w), `sel` the selection (score0, flat (Q,)) and its
    refinement (valid, kint (Q,), xy (Q, 2) octave coordinates)."""
    D = G[1:] - G[:-1]
    n, h, w = D.shape
    mg = extremum_margin(D).reshape(-1)
    picked = sel["score0"] > 0
    flat = sel["flat"].long()[picked]
    res = {"ext_gap": 0.0, "test_gap": 0.0}
    if flat.numel():
        res["ext_gap"] = float(torch.clamp_min(-mg[flat], 0.0).max()
                               .clamp_max(1.0))
    absd = D[1:n - 1].abs().reshape(-1)
    smin = (float(absd[flat].min()) if flat.numel() >= quota
            and flat.numel() else 0.0)
    left = mg > SURE_D
    left[flat] = False
    if bool(left.any()):
        res["ext_gap"] = max(res["ext_gap"],
                             float(absd[left].max()) - smin)
    if not flat.numel():
        return res
    k = flat // (h * w) + 1
    y, x = (flat % (h * w)) // w, flat % w
    r = relocate(D, k, y, x, gmax=float(G.abs().max()))
    pv = sel["valid"][picked].bool()
    px = torch.round(sel["xy"][picked].to(F64)).long()
    same = ((r["k"] == sel["kint"][picked].long()) & (r["x"] == px[:, 0])
            & (r["y"] == px[:, 1]))
    gap = torch.zeros_like(r["margin"])
    gap = torch.where(pv & (~r["alive"] | ~same), 1.0, gap)
    gap = torch.where(pv & r["alive"] & same & ~r["keep"],
                      (-r["margin"]).clamp(0.0, 1.0), gap)
    gap = torch.where(~pv & r["keep"], r["margin"].clamp(0.0, 1.0), gap)
    gap = torch.where(r["sure"], gap, 0.0)
    res["test_gap"] = float(gap.max())
    return res


def control_selection(octs, quotas) -> list:
    """The control's selection and refinement per octave: the reference's,
    on bfloat16 stacks in bfloat16."""
    out = []
    for G, q in zip(octs, quotas):
        D = G[1:] - G[:-1]
        n, h, w = D.shape
        mg = extremum_margin(D).reshape(-1)
        vals = torch.where(mg > 0, D[1:n - 1].abs().reshape(-1),
                           torch.zeros((), dtype=D.dtype, device=D.device))
        score0, flat = torch.sort(vals.float(), descending=True,
                                  stable=True)
        score0, flat = score0[:q], flat[:q]
        r = relocate(D, flat // (h * w) + 1, (flat % (h * w)) // w,
                     flat % w)
        xy = torch.stack([r["x"] + r["off"][:, 0].float(),
                          r["y"] + r["off"][:, 1].float()], -1)
        out.append({"score0": score0, "flat": flat,
                    "valid": r["keep"] & (score0 > 0), "kint": r["k"],
                    "xy": xy})
    return out


def _gradients(L):
    gx = torch.zeros_like(L)
    gy = torch.zeros_like(L)
    gx[:, 1:-1] = (L[:, 2:] - L[:, :-2]) * 0.5
    gy[1:-1] = (L[2:] - L[:-2]) * 0.5
    return gx, gy


def _samples(gx, gy, x, y, lin, radius):
    """Bilinear gradient samples (K, G, G) (rows y) of a grid lin x radius
    about (x, y), clamped 1 px inside each keypoint's 80-px patch. The
    positions are float64 whatever the gradients' type."""
    h, w = gx.shape
    py, px = min(PATCH, h), min(PATCH, w)
    x, y = x.to(F64), y.to(F64)
    lin, radius = lin.to(F64), radius.to(F64)
    x0 = (torch.round(x) - px // 2).clamp(0, w - px)
    y0 = (torch.round(y) - py // 2).clamp(0, h - py)
    ux = (x[:, None] + lin[None] * radius[:, None] - x0[:, None]).clamp(
        1.0, px - 2.001) + x0[:, None]
    uy = (y[:, None] + lin[None] * radius[:, None] - y0[:, None]).clamp(
        1.0, py - 2.001) + y0[:, None]
    ix, iy = torch.floor(ux), torch.floor(uy)
    fx = (ux - ix)[:, None, :].to(gx.dtype)
    fy = (uy - iy)[:, :, None].to(gx.dtype)
    ix, iy = ix.long()[:, None, :], iy.long()[:, :, None]

    def bil(g):
        return ((1 - fy) * ((1 - fx) * g[iy, ix] + fx * g[iy, ix + 1])
                + fy * ((1 - fx) * g[iy + 1, ix] + fx * g[iy + 1, ix + 1]))

    return bil(gx), bil(gy)


def orientation(gx, gy, x, y, scl):
    """The two orientation peaks (theta1, theta2) (K,) by the port's
    rule."""
    dt = gx.dtype
    half = (GRID - 1) / 2.0
    lin64 = ((torch.arange(GRID, dtype=F64) - half) / half).to(gx.device)
    lin = lin64.to(dt)
    vx, vy = _samples(gx, gy, x, y, lin64, 4.5 * scl.to(F64))
    r2 = lin[None, :] ** 2 + lin[:, None] ** 2
    win = torch.exp(-4.5 * r2) * (r2 <= 1.0)
    mag = torch.sqrt(vx * vx + vy * vy) * win
    ang = torch.atan2(vy, vx)
    b = torch.floor((ang / (2 * math.pi) + 0.5) * 36).long().clamp(0, 35)
    hist = torch.zeros((x.shape[0], 36), dtype=dt, device=gx.device)
    hist.scatter_add_(1, b.reshape(x.shape[0], -1), mag.reshape(
        x.shape[0], -1))
    hist = (torch.roll(hist, 2, -1) + 4 * torch.roll(hist, 1, -1) + 6 * hist
            + 4 * torch.roll(hist, -1, -1) + torch.roll(hist, -2, -1)) / 16.0
    hist = hist.to(F64)

    def theta(p):
        hp = hist.gather(1, p[:, None])[:, 0]
        hl = hist.gather(1, ((p - 1) % 36)[:, None])[:, 0]
        hr = hist.gather(1, ((p + 1) % 36)[:, None])[:, 0]
        den = hl - 2 * hp + hr
        it = torch.where(den.abs() > 1e-12, 0.5 * (hl - hr) / torch.where(
            den.abs() > 1e-12, den, torch.ones_like(den)), 0.0)
        return (p.to(F64) + it + 0.5) / 36 * 2 * math.pi - math.pi

    p1 = hist.argmax(1)
    local = (hist > torch.roll(hist, 1, -1)) & (hist > torch.roll(hist, -1, -1))
    other = torch.arange(36, device=gx.device)[None] != p1[:, None]
    cand = torch.where(local & other, hist, torch.full_like(hist, -math.inf))
    p2 = cand.argmax(1)
    return theta(p1), theta(p2), hist, p1, p2


def orientation_drop(hist, theta):
    """How far below the reference's nearest orientation peak the angle
    `theta` (K,) sits, as a share of the highest bin: the parabola through
    the smoothed histogram's bins p - 1, p, p + 1 of a local peak p, read
    at theta's bin position, below the parabola's top; a secondary peak
    short of 0.8 of the highest adds its shortfall. Any local peak within
    1.5 bins counts (rounding may reorder peaks of nearly equal height);
    1 where none is. A flat peak, whose angle rounding moves, costs little
    here."""
    k = hist.shape[0]
    b = (theta.to(F64) + math.pi) / (2 * math.pi) * 36 - 0.5
    hl, hr = torch.roll(hist, 1, -1), torch.roll(hist, -1, -1)
    a1, a2 = 0.5 * (hr - hl), 0.5 * (hl - 2 * hist + hr)
    top = torch.where(a2 < 0, hist - a1 * a1 / (4 * torch.where(
        a2 < 0, a2, -torch.ones_like(a2))), hist)
    top = torch.maximum(top, hist)
    x = torch.remainder(b[:, None] - torch.arange(36, device=hist.device,
                                                  dtype=F64) + 18.0,
                        36.0) - 18.0                               # (K, 36)
    val = hist + a1 * x + a2 * x * x
    h1 = hist.amax(1, keepdim=True)
    short = torch.clamp_min(0.8 * h1 - hist, 0.0)
    local = (hist > hl) & (hist > hr)
    drop = torch.where(local & (x.abs() <= 1.5),
                       torch.clamp_min(top - val, 0.0) + short,
                       torch.full_like(hist, math.inf))
    d = drop.amin(1) / torch.clamp_min(h1[:, 0], 1e-300)
    return torch.clamp(d, 0.0, 1.0).reshape(k)


def _tri(binf, n, wrap):
    b0 = torch.floor(binf)
    f = binf - b0
    b0 = b0.long()
    out = torch.zeros(*binf.shape, n, dtype=binf.dtype, device=binf.device)
    for b, wt in ((b0, 1 - f), (b0 + 1, f)):
        if wrap:
            out.scatter_add_(-1, torch.remainder(b, n)[..., None], wt[..., None])
        else:
            ok = (b >= 0) & (b < n)
            out.scatter_add_(-1, b.clamp(0, n - 1)[..., None],
                             (wt * ok)[..., None])
    return out


def descriptor(gx, gy, x, y, scl, theta):
    """The 128-vector (K, 128) at each keypoint and angle."""
    dt = gx.dtype
    lin64 = ((torch.arange(GRID, dtype=F64) + 0.5) / GRID * 2.0 - 1.0).to(
        gx.device)
    lin = lin64.to(dt)
    radius = 3.0 * scl.to(F64) * math.sqrt(2.0) * 5 * 0.5
    vx, vy = _samples(gx, gy, x, y, lin64, radius)
    gy_, gx_ = torch.meshgrid(lin, lin, indexing="ij")
    win = torch.exp(-(gx_ ** 2 + gy_ ** 2) * 25 / 16)
    mag = torch.sqrt(vx * vx + vy * vy) * win
    th = theta.to(dt)[:, None, None]
    ang = torch.atan2(vy, vx) - th
    ca, sa = torch.cos(th), torch.sin(th)
    gxr = gx_ * ca + gy_ * sa
    gyr = -gx_ * sa + gy_ * ca
    rbin = gyr * math.sqrt(2.0) * 2.5 + 1.5
    cbin = gxr * math.sqrt(2.0) * 2.5 + 1.5
    obin = torch.remainder(-ang / (2 * math.pi) * 8, 8)
    R, C, O = _tri(rbin, 4, False), _tri(cbin, 4, False), _tri(obin, 8, True)
    raw = torch.einsum("kyxr,kyxc,kyxo->krco", R, C, O * mag[..., None])
    raw = raw.reshape(x.shape[0], 128).to(F64)
    d = torch.clamp_max(raw / (raw.norm(dim=1, keepdim=True) + 1e-12), 0.2)
    return d / (d.norm(dim=1, keepdim=True) + 1e-12)


def frame_numbers(frame, det, state, noctaves, octs=None) -> dict:
    """The detection numbers of one frame: `det` its output keypoints
    (K, ...), `state` per octave the program's stack G (S + 3, h, w),
    octave xy (Q0, 2), layer, integer layer, and the descriptor stage's
    pidx, theta (Q,) of its output slots; `octs` the reference's stacks."""
    if octs is None:
        octs = scale_space(frame, noctaves)
    out = {"scale_gap": 0.0, "ext_gap": 0.0, "test_gap": 0.0,
           "refine_gap": 0.0, "kp_off": 0, "ori_gap": 0.0,
           "desc_gap": 0.0}
    start = 0
    for o, st in enumerate(state):
        G = octs[o]
        out["scale_gap"] = max(out["scale_gap"], float(
            (st["G"].to(F64) - G.to(F64)).abs().max()))
        q = st["pidx"].shape[0]
        sl = slice(start, start + q)
        start += q
        v = det["valid"][sl].bool()
        if not bool(v.any()):
            continue
        src = st["pidx"][v]
        xy = st["xy"][src].to(F64)
        lay, kint = st["lay"][src].to(F64), st["kint"][src].long()
        s = 0.5 * 2.0 ** o
        out["kp_off"] += int((det["xy"][sl][v].to(F64) != xy * s).any(1).sum())
        out["kp_off"] += int((det["angle"][sl][v] != st["theta"][v]).sum())
        out["kp_off"] += int((det["level"][sl][v] != o).sum())
        ix, iy = torch.round(xy[:, 0]).long(), torch.round(xy[:, 1]).long()
        H, g = system(G[1:] - G[:-1], kint, iy, ix)
        got = torch.stack([xy[:, 0] - ix, xy[:, 1] - iy, lay - kint], -1)
        out["refine_gap"] = max(out["refine_gap"], float(residual_roundings(
            H, g, got, G, kint, iy, ix).max()))
        scl = SIGMA0 * 2.0 ** (lay / S)
        th = st["theta"][v].to(F64)
        t1, d_ref = [], []
        for k in range(1, S + 1):
            m = kint == k
            if not bool(m.any()):
                continue
            gx, gy = _gradients(G[k])
            _, _, hist, p1, p2 = orientation(gx, gy, xy[m, 0], xy[m, 1],
                                             scl[m])
            t1.append((m, hist, p1, p2))
            d_ref.append((m, descriptor(gx, gy, xy[m, 0].to(gx.dtype),
                                        xy[m, 1].to(gx.dtype),
                                        scl[m].to(gx.dtype), th[m])))
        gap = torch.zeros_like(th)
        dd = torch.zeros_like(th)
        desc = det["desc"][sl][v].to(F64)
        for (m, hist, p1, p2), (_, d) in zip(t1, d_ref):
            gap[m] = orientation_drop(hist, th[m])
            dd[m] = (desc[m] - d).norm(dim=1)
        out["ori_gap"] = max(out["ori_gap"], float(gap.max()))
        out["desc_gap"] = max(out["desc_gap"], float(dd.max()))
    return out


def control_frame(frame, det, state, noctaves) -> tuple[dict, list]:
    """The control's detections and state: the reference's stacks,
    offsets, orientations and descriptors computed in bfloat16 at the
    program's keypoints, in the program's place."""
    bf = torch.bfloat16
    octs = scale_space(frame, noctaves, bf)
    det = {k: v.clone() for k, v in det.items()}
    new_state = []
    start = 0
    for o, st in enumerate(state):
        G = octs[o]
        st = dict(st, G=G.float())
        q = st["pidx"].shape[0]
        sl = slice(start, start + q)
        start += q
        v = det["valid"][sl].bool()
        if bool(v.any()):
            src = st["pidx"][v]
            xy = st["xy"][src]
            kint = st["kint"][src].long()
            ix, iy = torch.round(xy[:, 0]).long(), torch.round(xy[:, 1]).long()
            # an offset past half a sample would move the keypoint to
            # another sample: the control keeps it at this one
            off = offsets(G[1:] - G[:-1], kint, iy, ix).to(bf).float()
            off = off.clamp(-0.499, 0.499)
            xy_c = torch.stack([ix + off[:, 0], iy + off[:, 1]], -1).float()
            lay_c = (kint + off[:, 2]).float()
            st["xy"] = st["xy"].clone()
            st["lay"] = st["lay"].clone().float()
            st["xy"][src] = xy_c
            st["lay"][src] = lay_c
            scl = (SIGMA0 * 2.0 ** (lay_c.double() / S)).to(bf)
            th = torch.zeros(int(v.sum()), dtype=F64, device=frame.device)
            desc = torch.zeros((int(v.sum()), 128), dtype=F64,
                               device=frame.device)
            for k in range(1, S + 1):
                m = kint == k
                if not bool(m.any()):
                    continue
                gx, gy = _gradients(G[k])
                xb, yb = xy_c[m, 0].to(bf), xy_c[m, 1].to(bf)
                a = orientation(gx, gy, xb, yb, scl[m])[0]
                th[m] = a.to(bf).double()
                desc[m] = descriptor(gx, gy, xb, yb, scl[m], th[m]).to(bf).double()
            theta = st["theta"].clone()
            theta[v] = th.float()
            st["theta"] = theta
            s = 0.5 * 2.0 ** o
            xs = det["xy"][sl].clone()
            xs[v] = xy_c * s
            an = det["angle"][sl].clone()
            an[v] = th.float()
            ds = det["desc"][sl].clone()
            ds[v] = desc.float()
            det["xy"][sl], det["angle"][sl], det["desc"][sl] = xs, an, ds
        new_state.append(st)
    return det, new_state


def numbers(sample: dict, control: bool = False) -> dict:
    """Every number of the sift check over a sample (see
    posebench/harness.py `build_sample`): the worst over its frames and
    pairs."""
    cfg = sample["config"]["estimator"]
    nocts = int(cfg["sift"]["noctaves"])
    mm = int(cfg["matcher"]["max_matches"])
    out = {"scale_gap": 0.0, "ext_gap": 0.0, "test_gap": 0.0,
           "refine_gap": 0.0, "kp_off": 0, "ori_gap": 0.0,
           "desc_gap": 0.0, "match_gap": 0.0, "inlier_gap": 0.0,
           "inlier_short": None,
           "rot_gap": 0.0, "pose_off": 0}
    quotas = octave_quotas(int(cfg["sift"]["max_kpts"]), nocts)
    for f, frame in sample["frames"].items():
        det, state = sample["dets"][f], sample["state"][f]
        octs = scale_space(frame, nocts)
        sel = state
        if control:
            sel = control_selection(scale_space(frame, nocts,
                                                torch.bfloat16), quotas)
            det, state = control_frame(frame, det, state, nocts)
        if len(sel) != len(octs):
            raise ValueError(f"{len(sel)} octaves selected, {len(octs)} "
                             f"in the reference's scale space")
        for G, st, q in zip(octs, sel, quotas):
            if st["score0"].shape[0] != q:
                raise ValueError(f"{st['score0'].shape[0]} samples "
                                 f"selected in an octave of quota {q}")
            for k, v in selection_numbers(G, st, q).items():
                out[k] = max(out[k], v)
        for k, v in frame_numbers(frame, det, state, nocts, octs).items():
            out[k] = max(out[k], v) if not k.endswith("_off") else out[k] + v
    for p in sample["pairs"]:
        d1, d2 = sample["dets"][p["f1"]], sample["dets"][p["f2"]]
        v1, v2 = d1["valid"].bool(), d2["valid"].bool()
        m = p["matches"]
        if control:
            m = matching.control(d1["desc"], d2["desc"], v1, v2, "l2", mm)
        out["match_gap"] = max(out["match_gap"], matching.match_gap(
            m, d1["desc"], d2["desc"], v1, v2, "l2", mm))
        pr = dict(p["pose"], xy1=d1["xy"], xy2=d2["xy"], idx1=m["idx1"],
                  idx2=m["idx2"], mvalid_matcher=m["valid"])
        if control:
            pr = pose.control_pair(pr, sample["K"],
                                   cfg["ransac"]["threshold_px"])
        r = pose.judge_pair(pr, sample["K"], cfg["ransac"]["threshold_px"],
                            truth=p["truth"])
        out["inlier_gap"] = max(out["inlier_gap"], r["inlier_gap"])
        out["inlier_short"] = pose.worst(out["inlier_short"],
                                         r["inlier_short"])
        out["rot_gap"] = max(out["rot_gap"], r["rot_gap"])
        out["pose_off"] += r["pose_off"]
        if r["notes"]:
            out.setdefault("pose_notes", []).extend(
                f"call {p['call']} pair {p['pair']}: {n}" for n in r["notes"])
    return out
