"""Plain reference of ORB detection (the orb4000 configuration), float64,
and the configuration's whole check: detection, matching, pose.

The semantics are those the port states for its ORB (ops/orb.py,
ops/pyramid.py, ops/fast.py): level l of a frame is its linear resize
(`jax.image.resize(..., "linear")`: half-pixel centres, the triangle kernel
widened by the zoom when shrinking, weights normalised) to
round(h / 1.1^l) x round(w / 1.1^l); a keypoint at level pixel (x, y) has the
Harris response det(M) - 0.04 trace(M)^2 of central-difference gradients
summed over the 7 x 7 window; its angle is atan2(m01, m10) of the intensity
centroid over OpenCV's radius-15 disk of the level; its 256 bits compare the
7 x 7 sigma-2 Gaussian blur of the level at the pattern's point pairs
rotated by the angle and rounded half-to-even (the pattern: 512 points of a
normal with sigma 31/5, rounded, within radius 13, numpy's default_rng(12345)).

Which pixels become keypoints: on each level, a FAST-9 corner at threshold
t (9 contiguous pixels of the radius-3 circle all brighter than the centre
by more than t, or all darker) whose FAST score (the larger of the bright
and dark sums of |d| - t) is no less than any of its 8 neighbours' (0 for a
neighbour that is no corner), at least 19 px inside the level; of those,
OpenCV's geometric quota of the level by Harris response, the lowest index
first among equal responses. The atlas stacks the levels from row 24 with
24 rows between them; the keypoints, in level order, are then sorted
stably into 32-row bands of their patch's top row and each band keeps its
first `extract_cap`: the output is that order, the band's overflow invalid.
The program's selection before the bands' cap is judged on the reference's
level images, and the output against the bands' rule:
  fast_gap    the widest margin (intensity) by which a selected keypoint
              fails the FAST test or the non-max suppression against a
              neighbour that is surely a corner
  select_gap  the widest Harris response, over (a + b)^2 at that pixel,
              by which a pixel left out that is surely a candidate (FAST
              and non-max decided by more than SURE) outscores the weakest
              keypoint kept on its level; 1 where a level kept fewer than
              its quota and left such a pixel out
  sel_off     broken exact rules: a keypoint over its level's quota or in
              its border, a level-0 position that is not its level pixel
              scaled, an output slot that is not the bands' order of the
              selection (a count)

Each keypoint the program returned is judged at its own position, level and
angle:
  harris_gap  the widest |score - R| / (a + b)^2, a and b the window's
              gradient sums (the response's scale)
  angle_gap   the widest |angle - reference angle| x |m| / S, the angle's
              error as a share of the moments' scale S = sum |u| I
  brief_gap   the widest |v1 - v0| (intensity units) of a bit the program
              set against the reference's samples; a point whose rotated
              coordinate lies within 1e-3 of a rounding edge may take
              either pixel
Nothing here imports the program.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import matching, pose

F64 = torch.float64
PATCH_R = 15
PATTERN_R = 13
HARRIS_K = 0.04
EDGE = 1e-3
BORDER = 19
ATLAS_GAP = 24
SURE = 0.01
CIRCLE = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
          (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2),
          (-1, -3))


def level_shapes(h, w, nlevels, scale):
    return [(int(round(h / scale ** l)), int(round(w / scale ** l)))
            for l in range(nlevels)]


@functools.lru_cache(maxsize=64)
def resize_matrix(n_in: int, n_out: int, device, dtype=F64):
    """(n_out, n_in) weights of the antialiased linear resize."""
    inv = n_in / n_out
    ks = max(inv, 1.0)
    pos = (torch.arange(n_out, dtype=F64) + 0.5) * inv - 0.5
    x = (pos[:, None] - torch.arange(n_in, dtype=F64)[None]).abs() / ks
    wts = torch.clamp_min(1.0 - x, 0.0)
    tot = wts.sum(1, keepdim=True)
    wts = torch.where(tot > 0, wts / torch.where(tot > 0, tot, 1.0), 0.0)
    inside = (pos >= -0.5) & (pos <= n_in - 0.5)
    return torch.where(inside[:, None], wts, 0.0).to(device=device,
                                                     dtype=dtype)


def level_image(frame, lh, lw, dtype=F64):
    h, w = frame.shape
    if (lh, lw) == (h, w):
        return frame.to(dtype)
    rows = resize_matrix(h, lh, frame.device, dtype)
    cols = resize_matrix(w, lw, frame.device, dtype)
    return rows @ frame.to(dtype) @ cols.T


def gaussian_taps(ksize=7, sigma=2.0):
    x = np.arange(ksize, dtype=np.float64) - ksize // 2
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def blur(img):
    """7 x 7 sigma-2 Gaussian, separable, edges reflected."""
    k = torch.tensor(gaussian_taps(), dtype=img.dtype, device=img.device)
    x = torch.nn.functional.pad(img[None, None], (3, 3, 3, 3),
                                mode="reflect")[0, 0]
    v = sum(k[i] * x[i:i + img.shape[0]] for i in range(7))
    return sum(k[i] * v[:, i:i + img.shape[1]] for i in range(7))


@functools.lru_cache(maxsize=None)
def pattern() -> np.ndarray:
    """The 256 point pairs (256, 2, 2) (x, y) of the Gaussian pattern."""
    rng = np.random.default_rng(12345)
    pts = []
    while len(pts) < 512:
        c = np.round(rng.normal(0.0, 31.0 / 5.0, size=(1024, 2))).astype(int)
        pts.extend(map(tuple, c[(c ** 2).sum(1) <= PATTERN_R ** 2]))
    return np.array(pts[:512]).reshape(256, 2, 2)


@functools.lru_cache(maxsize=None)
def disk():
    """OpenCV's IC_Angle disk of radius 15: (31, 31) bool."""
    hp = PATCH_R
    umax = [0] * (hp + 2)
    vmax = int(math.floor(hp * math.sqrt(2.0) / 2 + 1))
    vmin = int(math.ceil(hp * math.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(np.rint(math.sqrt(hp * hp - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    u = np.arange(-hp, hp + 1)
    lim = np.array([umax[abs(v)] for v in u])
    return np.abs(u[None]) <= lim[:, None]


def _window(img, ix, iy, r):
    """img values at (iy + dy, ix + dx), |dx|, |dy| <= r: (K, 2r+1, 2r+1)."""
    d = torch.arange(-r, r + 1, device=img.device)
    return img[(iy[:, None] + d)[:, :, None], (ix[:, None] + d)[:, None, :]]


def harris(L, ix, iy):
    """(response, a + b) at each keypoint of level image L."""
    dx = torch.zeros_like(L)
    dy = torch.zeros_like(L)
    dx[:, 1:-1] = L[:, 2:] - L[:, :-2]
    dy[1:-1] = L[2:] - L[:-2]
    gx, gy = _window(dx, ix, iy, 3), _window(dy, ix, iy, 3)
    a = (gx * gx).sum((1, 2))
    b = (gy * gy).sum((1, 2))
    c = (gx * gy).sum((1, 2))
    return a * b - c * c - HARRIS_K * (a + b) ** 2, a + b


def moments(L, ix, iy):
    """(m10, m01, scale) of the IC disk at each keypoint."""
    P = _window(L, ix, iy, PATCH_R)
    m = torch.as_tensor(disk(), device=L.device)
    u = torch.arange(-PATCH_R, PATCH_R + 1, device=L.device, dtype=L.dtype)
    P = torch.where(m, P, torch.zeros((), dtype=L.dtype, device=L.device))
    m10 = (P * u[None, None]).sum((1, 2))
    m01 = (P * u[None, :, None]).sum((1, 2))
    return m10, m01, (P * u.abs()[None, None]).sum((1, 2))


def _candidates(r):
    """The pixel offsets a rotated coordinate r may round to: (K, N, 2)."""
    lo = torch.floor(r)
    near = ((r - lo) - 0.5).abs() < EDGE
    rnd = torch.round(r)                       # half to even
    return torch.stack([rnd, torch.where(near, lo + 1.0 - (rnd - lo), rnd)],
                       dim=-1)


def brief_values(Bl, ix, iy, angle):
    """Sample values of each keypoint's 512 points, every rounding the
    angle allows: (K, 512, 4)."""
    pat = torch.as_tensor(pattern().reshape(512, 2), dtype=F64,
                          device=Bl.device)
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    rx = pat[None, :, 0] * ca - pat[None, :, 1] * sa
    ry = pat[None, :, 0] * sa + pat[None, :, 1] * ca
    cx, cy = _candidates(rx), _candidates(ry)           # (K, 512, 2)
    xs = (ix[:, None, None, None] + cx[..., :, None]).long()
    ys = (iy[:, None, None, None] + cy[..., None, :]).long()
    return Bl[ys, xs].reshape(ix.shape[0], 512, 4)


def brief_gap(values, bits):
    """values (K, 512, 4) of the points (pair k: points 2k, 2k+1), bits
    (K, 256) -> the widest |v1 - v0| of a bit no rounding explains."""
    v = values.reshape(values.shape[0], 256, 2, 4)
    v0, v1 = v[:, :, 0, :, None], v[:, :, 1, None, :]   # (K, 256, 4, 4)
    lt = v0 < v1
    b = bits.bool()[..., None, None]
    ok = (lt == b).any(-1).any(-1)
    if bool(ok.all()):
        return 0.0
    gap = (v1 - v0).abs().amin((-1, -2))
    return float(gap[~ok].max())


def frame_attributes(frame, xy, level, angle, nlevels, scale,
                     dtype=F64):
    """The reference's per-keypoint attributes of one frame: score,
    (m10, m01, S), the level pixel (ix, iy), and the sample values at the
    given angles, in `dtype` (bfloat16 for the control)."""
    h, w = frame.shape
    k = xy.shape[0]
    dev = frame.device
    out = {"score": torch.zeros(k, dtype=F64, device=dev),
           "ab": torch.ones(k, dtype=F64, device=dev),
           "m10": torch.zeros(k, dtype=F64, device=dev),
           "m01": torch.zeros(k, dtype=F64, device=dev),
           "S": torch.ones(k, dtype=F64, device=dev),
           "values": torch.zeros((k, 512, 4), dtype=F64, device=dev)}
    for l, (lh, lw) in enumerate(level_shapes(h, w, nlevels, scale)):
        sel = torch.nonzero(level == l)[:, 0]
        if sel.numel() == 0:
            continue
        ip = torch.round(xy[sel].to(F64) / scale ** l)
        ix, iy = ip[:, 0].long(), ip[:, 1].long()
        if (int(ix.min()) < PATCH_R + 3 or int(iy.min()) < PATCH_R + 3
                or int(ix.max()) >= lw - PATCH_R - 3
                or int(iy.max()) >= lh - PATCH_R - 3):
            raise ValueError(f"a keypoint of level {l} lies within "
                             f"{PATCH_R + 3} px of its edge")
        L = level_image(frame, lh, lw, dtype)
        r, ab = harris(L, ix, iy)
        m10, m01, S = moments(L, ix, iy)
        vals = brief_values(blur(L), ix, iy, angle[sel].to(F64))
        for key, val in (("score", r), ("ab", ab), ("m10", m10),
                         ("m01", m01), ("S", S), ("values", vals)):
            out[key][sel] = val.to(F64)
    return out


def detection_numbers(det: dict, frame, nlevels, scale) -> dict:
    """harris_gap, angle_gap and brief_gap of one frame's detections (the
    program's, or the control's in their place)."""
    v = det["valid"].bool()
    xy, level = det["xy"][v], det["level"][v]
    angle = det["angle"][v].to(F64)
    ref = frame_attributes(frame, xy, level, angle, nlevels, scale)
    hg = ((det["score"][v].to(F64) - ref["score"]).abs()
          / torch.clamp_min(ref["ab"] ** 2, 1e-12))
    ang = torch.atan2(ref["m01"], ref["m10"])
    d = torch.remainder(angle - ang + math.pi, 2 * math.pi) - math.pi
    mag = torch.sqrt(ref["m10"] ** 2 + ref["m01"] ** 2)
    return {"harris_gap": float(hg.max()) if hg.numel() else 0.0,
            "angle_gap": float((d.abs() * mag
                                / torch.clamp_min(ref["S"], 1e-12)).max())
            if d.numel() else 0.0,
            "brief_gap": brief_gap(ref["values"], det["bits"][v])}


def level_quotas(nfeatures: int, nlevels: int, scale: float):
    """OpenCV ORB's geometric per-level quotas of `nfeatures`."""
    f = 1.0 / scale
    n0 = nfeatures * (1.0 - f) / (1.0 - f ** nlevels)
    q = [int(round(n0 * f ** l)) for l in range(nlevels - 1)]
    return q + [max(nfeatures - sum(q), 0)]


def atlas_rows(h, w, nlevels, scale):
    """Each level's first atlas row, and the atlas's rows."""
    row, offs = ATLAS_GAP, []
    for lh, _ in level_shapes(h, w, nlevels, scale):
        offs.append(row)
        row += lh + ATLAS_GAP
    return offs, -(-row // 32) * 32 + 64


def fast_maps(L, t: float):
    """FAST over level image L (h, w): (arc, score) (h, w), -inf and 0
    within 3 px of the edge. `arc` is the largest m for which 9 contiguous
    circle pixels all differ from the centre by more than m, all brighter
    or all darker (a corner iff arc > t); `score` the larger of the bright
    and dark sums of |d| - t over the circle's pixels past t."""
    h, w = L.shape
    c = L[3:h - 3, 3:w - 3]
    d = torch.stack([L[3 + dy:h - 3 + dy, 3 + dx:w - 3 + dx] - c
                     for dx, dy in CIRCLE])

    def run9(x):
        x = torch.cat([x, x[:8]])
        best = x[0:9].amin(0)
        for i in range(1, 16):
            best = torch.maximum(best, x[i:i + 9].amin(0))
        return best

    a = torch.maximum(run9(d), run9(-d))
    sc = torch.maximum(torch.clamp_min(d - t, 0).sum(0),
                       torch.clamp_min(-d - t, 0).sum(0))
    arc = torch.full((h, w), -math.inf, dtype=L.dtype, device=L.device)
    score = torch.zeros((h, w), dtype=L.dtype, device=L.device)
    arc[3:h - 3, 3:w - 3] = a
    score[3:h - 3, 3:w - 3] = sc
    return arc, score


def neighbour_max(x):
    """The largest of each pixel's 8 neighbours of a map >= 0 (0 past the
    edge)."""
    h, w = x.shape
    p = torch.nn.functional.pad(x, (1, 1, 1, 1))
    return torch.stack([p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
                        for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                        if dy or dx]).amax(0)


def harris_map(L):
    """(response, a + b) (h, w) of every pixel 3 px or more inside L, 0
    nearer the edge: `harris` at every pixel."""
    h, w = L.shape
    dx = torch.zeros_like(L)
    dy = torch.zeros_like(L)
    dx[:, 1:-1] = L[:, 2:] - L[:, :-2]
    dy[1:-1] = L[2:] - L[:-2]

    def box(x):
        v = sum(x[i:i + h - 6] for i in range(7))
        return sum(v[:, i:i + w - 6] for i in range(7))

    a, b, c = box(dx * dx), box(dy * dy), box(dx * dy)
    r = torch.zeros_like(L)
    ab = torch.zeros_like(L)
    r[3:h - 3, 3:w - 3] = a * b - c * c - HARRIS_K * (a + b) ** 2
    ab[3:h - 3, 3:w - 3] = a + b
    return r, ab


def interior(lh, lw, device):
    ys = torch.arange(lh, device=device)[:, None]
    xs = torch.arange(lw, device=device)[None]
    return ((ys >= BORDER) & (ys < lh - BORDER) & (xs >= BORDER)
            & (xs < lw - BORDER))


def band_order(pre: dict, ha: int, band: int, cap: int) -> dict:
    """The output the bands' rule makes of a selection `pre` (xy_atlas,
    xy_base, level, score, valid (K, ...)): the stable order by the band of
    each patch's top row (invalid keypoints last), a band's keypoints past
    its first `cap` invalid."""
    v = pre["valid"].bool()
    nb = ha // band
    y0 = torch.clamp(pre["xy_atlas"][:, 1].long() - PATCH_R, 0,
                     ha - 2 * PATCH_R - 1)
    bnd = torch.where(v, torch.clamp(y0 // band, 0, nb - 1), nb - 1)
    order = torch.sort(bnd, stable=True).indices
    bs = bnd[order].contiguous()
    pos = torch.arange(bs.shape[0], device=bs.device) - torch.searchsorted(
        bs, bs)
    return {"xy": pre["xy_base"][order], "level": pre["level"][order],
            "score": pre["score"][order], "valid": v[order] & (pos < cap)}


def selection_numbers(frame, pre: dict, out: dict, orb: dict) -> dict:
    """fast_gap, select_gap and sel_off of one frame: `pre` the selection
    before the bands' cap, `out` the frame's output keypoints."""
    h, w = frame.shape
    nl, sc = int(orb["nlevels"]), float(orb["scale_factor"])
    t = float(orb["fast_threshold"])
    quotas = level_quotas(int(orb["nfeatures"]), nl, sc)
    offs, ha = atlas_rows(h, w, nl, sc)
    v = pre["valid"].bool()
    lev = pre["level"].long()
    res = {"fast_gap": 0.0, "select_gap": 0.0, "sel_off": 0}
    for l, (lh, lw) in enumerate(level_shapes(h, w, nl, sc)):
        m = v & (lev == l)
        n = int(m.sum())
        res["sel_off"] += max(n - quotas[l], 0)
        if quotas[l] <= 0 or lh <= 2 * BORDER or lw <= 2 * BORDER:
            res["sel_off"] += n
            continue
        x = pre["xy_atlas"][m, 0].long()
        y = pre["xy_atlas"][m, 1].long() - offs[l]
        base = torch.round(pre["xy_base"][m].to(F64) / sc ** l)
        ok = ((x >= BORDER) & (x < lw - BORDER) & (y >= BORDER)
              & (y < lh - BORDER))
        res["sel_off"] += int((~ok).sum()) + int(
            (base != torch.stack([x, y], 1)).any(1).sum())
        x, y = x[ok], y[ok]
        L = level_image(frame, lh, lw)
        arc, score = fast_maps(L, t)
        lenient = neighbour_max(torch.where(arc > t + SURE, score, 0.0))
        strict = neighbour_max(torch.where(arc > t - SURE, score, 0.0))
        if x.numel():
            fail = torch.maximum(t - arc[y, x], lenient[y, x] - score[y, x])
            res["fast_gap"] = max(res["fast_gap"], float(fail.max()))
        r, ab = harris_map(L)
        kept = torch.zeros((lh, lw), dtype=torch.bool, device=L.device)
        kept[y, x] = True
        cand = (interior(lh, lw, L.device) & (arc > t + SURE)
                & (score - strict > SURE) & ~kept)
        if bool(cand.any()):
            if n >= quotas[l] and x.numel():
                smin = r[y, x].min()
                gap = float(((r[cand] - smin)
                             / torch.clamp_min(ab[cand] ** 2, 1e-12)).max())
            else:
                gap = 1.0
            res["select_gap"] = max(res["select_gap"], gap)
    want = band_order(pre, ha, int(orb["band"]), int(orb["extract_cap"]))
    got_v = out["valid"].bool()
    either = got_v | want["valid"]
    res["sel_off"] += int(((got_v != want["valid"])
                           | (either & ((out["xy"] != want["xy"]).any(1)
                                        | (out["level"] != want["level"])
                                        | (out["score"] != want["score"])))
                           ).sum())
    return res


def control_selection(frame, orb: dict, max_kpts: int) -> tuple[dict, dict]:
    """The control's selection before the bands' cap and its output order:
    the reference's selection on bfloat16 level images, FAST, non-max and
    Harris computed in bfloat16."""
    bf = torch.bfloat16
    h, w = frame.shape
    nl, sc = int(orb["nlevels"]), float(orb["scale_factor"])
    t = float(orb["fast_threshold"])
    quotas = level_quotas(int(orb["nfeatures"]), nl, sc)
    offs, ha = atlas_rows(h, w, nl, sc)
    parts = []
    for l, (lh, lw) in enumerate(level_shapes(h, w, nl, sc)):
        if quotas[l] <= 0 or lh <= 2 * BORDER or lw <= 2 * BORDER:
            continue
        L = level_image(frame, lh, lw, bf)
        arc, score = fast_maps(L, t)
        corner = arc > t
        s = torch.where(corner, score, torch.zeros_like(score))
        cand = corner & (s >= neighbour_max(s)) & interior(lh, lw, L.device)
        r, _ = harris_map(L)
        rank = torch.where(cand, r.float(), -math.inf).reshape(-1)
        vals, idx = torch.sort(rank, descending=True, stable=True)
        vals, idx = vals[:quotas[l]], idx[:quotas[l]]
        x, y = (idx % lw).float(), (idx // lw).float()
        parts.append({"xy_atlas": torch.stack([x, y + offs[l]], 1),
                      "xy_base": torch.stack([x, y], 1) * sc ** l,
                      "level": torch.full_like(idx, l, dtype=torch.int32),
                      "score": vals, "valid": vals > -math.inf})
    pre = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    pad = max_kpts - pre["valid"].shape[0]
    if pad > 0:
        pre = {k: torch.nn.functional.pad(
            v, (0, 0, 0, pad) if v.dim() == 2 else (0, pad))
            for k, v in pre.items()}
    return pre, band_order(pre, ha, int(orb["band"]),
                           int(orb["extract_cap"]))


def control_detections(det: dict, frame, nlevels, scale) -> dict:
    """The control's detections: the reference's attributes at the
    program's keypoints, computed in bfloat16."""
    bf = torch.bfloat16
    v = det["valid"].bool()
    xy, level = det["xy"][v], det["level"][v]
    a = frame_attributes(frame, xy, level, torch.zeros(int(v.sum()),
                         dtype=F64, device=frame.device), nlevels, scale,
                         dtype=bf)
    angle = torch.atan2(a["m01"].to(bf), a["m10"].to(bf)).to(F64)
    b = frame_attributes(frame, xy, level, angle, nlevels, scale, dtype=bf)
    vals = b["values"].reshape(-1, 256, 2, 4)[..., 0]
    out = {k: t[v] for k, t in det.items()}
    out.update(score=a["score"], angle=angle,
               bits=(vals[..., 0] < vals[..., 1]).to(torch.uint8),
               valid=torch.ones_like(out["valid"]))
    return out


def numbers(sample: dict, control: bool = False) -> dict:
    """Every number of the orb4000 check over a sample (see
    posebench/harness.py `build_sample`): the worst over its frames and
    pairs."""
    cfg = sample["config"]["estimator"]
    orb = cfg["orb"]
    nl, sc = int(orb["nlevels"]), float(orb["scale_factor"])
    mm = int(cfg["matcher"]["max_matches"])
    out = {"harris_gap": 0.0, "angle_gap": 0.0, "brief_gap": 0.0,
           "fast_gap": 0.0, "select_gap": 0.0, "sel_off": 0,
           "match_off": 0, "inlier_gap": 0.0, "inlier_short": None,
           "rot_gap": 0.0, "pose_off": 0}
    for f, frame in sample["frames"].items():
        det = sample["dets"][f]
        if control:
            det = control_detections(det, frame, nl, sc)
        for k, v in detection_numbers(det, frame, nl, sc).items():
            out[k] = max(out[k], v)
        if control:
            pre, final = control_selection(frame, orb, int(orb["max_kpts"]))
        else:
            pre, final = sample["state"][f][0], sample["dets"][f]
        for k, v in selection_numbers(frame, pre, final, orb).items():
            out[k] = out[k] + v if k.endswith("_off") else max(out[k], v)
    for p in sample["pairs"]:
        d1, d2 = sample["dets"][p["f1"]], sample["dets"][p["f2"]]
        v1, v2 = d1["valid"].bool(), d2["valid"].bool()
        m = p["matches"]
        if control:
            m = matching.control(d1["bits"], d2["bits"], v1, v2, "hamming",
                                 mm)
        out["match_off"] += matching.match_off(
            m, d1["bits"], d2["bits"], v1, v2, "hamming", mm)
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
