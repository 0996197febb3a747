"""The least time the card could take for each of the port's kernels on the
work of the traced calls: max(bytes / HBM bandwidth, operations / peak).

The counts are functions of the cell's shapes and of live counts that the
calls' own inputs and outputs give (valid keypoints and where they lie,
valid descriptors, real 5-point roots, the geometry products' operands),
never of a kernel's launch configuration, so they count the same work
whatever implements it. Bytes count each input read once and each output
written once. The per-kernel formulas are those of the repository's
`chip_smoke.py` (K1, K2, K3, K4, K7, P1; its P2 count walks every operand's
addresses, this one counts the distinct operands and the outputs), made
independent of the program's padded layouts: K1 counts the pyramid's pixels
and not the padded atlas's, K2 its live keypoints and not its slots.

A roofline unit is a set of kernel functions that one wrapper launches
together (K3's tile kernel and its column pass), named by the function names
in the program's sources (posebench/devtrace.py `own_kernels`).
"""

from __future__ import annotations

import math

import torch

# NVIDIA H100 SXM, data sheet, dense rates
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12                 # CUDA-core float32
TF32X3_OPS_PER_S = 494.7e12 / 3        # 3xTF32 tensor-core products (K7)
INT8_OPS_PER_S = 1979e12               # int8 tensor cores (K3)

UNITS = {
    "K1": ("fast_harris_kernel",),
    "K2": ("extract_brief_kernel",),
    "K3": ("hamming_tc_kernel", "finalize_cols32"),
    "K4": ("roots_kernel", "polish_kernel"),
    "K7": ("split_kernel", "l2_tc_kernel", "finalize_cols"),
    "P1": ("coeffs_kernel",),
    "P2": ("group_bmm_kernel",),
    "P3": ("ori_hist_kernel",),
    "P4": ("desc_kernel",),
}

# per-unit constants, chip_smoke.py's
K4_OPS_PER_PROBLEM = 97 * 835          # the bracketing of one problem
K4_OPS_PER_ROOT = 10 * 835 + 11000     # one root's bisection and polish
K4_BYTES_PER_PROBLEM = 800 + 10 * 14   # 10 x 20 coefficients in, roots out
P1_OPS = 7761                          # per 5-point hypothesis
P1_BYTES = 80 + (36 + 200) * 4
P3_OPS_PER_SAMPLE, P4_OPS_PER_SAMPLE, P4_OPS_PER_SLOT = 25, 70, 512
SIFT_GRID = 24 * 24


def bound_s(nbytes: float, ops: float, rate: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / rate)


def _union_px(points, shape) -> int:
    """Distinct pixels among integer points (N, 2) (x, y) of an image of
    `shape`, those outside dropped."""
    h, w = shape
    x, y = points[:, 0].long(), points[:, 1].long()
    ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    m = torch.zeros(h * w, dtype=torch.bool, device=points.device)
    m[(y[ok] * w + x[ok])] = True
    return int(m.sum())


def orb_counts(dets: dict, h: int, w: int, orb: dict) -> dict:
    """K1's and K2's counts for one ORB detection call (dets (F, K, ...))."""
    from reference import orb as ref

    f = dets["valid"].shape[0]
    nl, sc = int(orb["nlevels"]), float(orb["scale_factor"])
    shapes = ref.level_shapes(h, w, nl, sc)
    px = f * sum(lh * lw for lh, lw in shapes)
    out = {"K1": (12.0 * px, 180.0 * px, FP32_OPS_PER_S)}
    disk = torch.as_tensor(ref.disk(), device=dets["xy"].device)
    dy, dx = torch.nonzero(disk, as_tuple=True)
    off_ic = torch.stack([dx, dy], 1) - ref.PATCH_R               # (n_ic, 2)
    pat = torch.as_tensor(ref.pattern().reshape(512, 2),
                          device=dets["xy"].device, dtype=torch.float32)
    raw_px = blur_px = 0
    valid = dets["valid"].bool()
    n_live = int(valid.sum())
    for fi in range(f):
        v = valid[fi]
        for l, shape in enumerate(shapes):
            sel = v & (dets["level"][fi] == l)
            if not bool(sel.any()):
                continue
            c = torch.round(dets["xy"][fi][sel].double() / sc ** l).long()
            raw_px += _union_px((c[:, None] + off_ic[None]).reshape(-1, 2),
                                shape)
            a = dets["angle"][fi][sel].float()
            ca, sa = torch.cos(a)[:, None], torch.sin(a)[:, None]
            rx = torch.round(pat[None, :, 0] * ca - pat[None, :, 1] * sa)
            ry = torch.round(pat[None, :, 0] * sa + pat[None, :, 1] * ca)
            s = torch.stack([rx, ry], -1).long() + c[:, None]
            blur_px += _union_px(s.reshape(-1, 2), shape)
    n_ic = int(off_ic.shape[0])
    out["K2"] = (4.0 * (raw_px + blur_px) + 256 * 16 + n_live * (256 + 8),
                 n_live * (4.0 * n_ic + 256 * 12), FP32_OPS_PER_S)
    return out


def match_counts(dets: dict, key: str, dim_bytes: int, rate: float,
                 unit: str) -> dict:
    """The cross-check matcher's counts over the call's P = F - 1 pairs:
    valid descriptors read once, the masks, three int32 outputs a row and a
    column, and 2 x dim operations per valid row x valid column."""
    v = dets["valid"].bool()
    v1, v2 = v[:-1], v[1:]
    n1, n2 = v1.shape[1], v2.shape[1]
    p = v1.shape[0]
    nv = v1.sum(1).double(), v2.sum(1).double()
    dim = dets[key].shape[-1]
    nbytes = (float(nv[0].sum() + nv[1].sum()) * dim * dim_bytes
              + p * (n1 + n2) + 4.0 * p * (2 * n1 + n2))
    ops = 2.0 * float((nv[0] * nv[1]).sum()) * dim
    return {unit: (nbytes, ops, rate)}


def ransac_counts(pairs: int, hyps: int, roots: int) -> dict:
    """K4's and P1's counts for `pairs` x `hyps` 5-point problems of which
    `roots` real roots were found."""
    m = pairs * hyps
    return {"K4": (m * K4_BYTES_PER_PROBLEM,
                   m * K4_OPS_PER_PROBLEM + roots * K4_OPS_PER_ROOT,
                   FP32_OPS_PER_S),
            "P1": (m * P1_BYTES, m * P1_OPS, FP32_OPS_PER_S)}


def p2_terms(terms, outs):
    """What the P2 count needs of one launch, taken while the call runs:
    each operand's (shape, strides, storage) and each output's size."""
    return ([tuple(None if x is None else
                   (tuple(x.shape), x.stride(), x.untyped_storage().data_ptr())
                   for x in t) for t in terms], [o.numel() for o in outs])


def p2_counts(launch) -> tuple[float, float]:
    """Bytes and float operations of one P2 launch (`p2_terms`): the
    distinct operand tensors read once (a broadcast dimension counted
    once), the outputs written once; 2 k operations an output of a product,
    k of a row sum, and a chain's inner product besides."""
    terms, outs = launch
    seen = {}
    flops = 0.0
    for t, o in zip(terms, outs):
        for x in t:
            if x is None:
                continue
            shape, stride, ptr = x
            n = math.prod(s for s, st in zip(shape, stride) if st != 0)
            seen[ptr] = max(seen.get(ptr, 0), n)
        k = t[0][0][-1]
        if len(t) == 2 and t[1] is None:
            flops += o * k
        elif len(t) == 2:
            flops += 2.0 * o * k
        else:
            a2, b = t[1][0], t[2][0]
            inner = math.prod(torch.broadcast_shapes(a2[:-2], b[:-2]))
            flops += 2.0 * inner * a2[-2] * b[-1] * a2[-1]
            flops += 2.0 * o * k
    return 4.0 * (sum(seen.values()) + sum(outs)), flops


def add(total: dict, more: dict) -> dict:
    for unit, (b, o, r) in more.items():
        if unit in total:
            b0, o0, _ = total[unit]
            total[unit] = (b0 + b, o0 + o, r)
        else:
            total[unit] = (b, o, r)
    return total


def _sampled_px(ucx, ucy, radius, lin, py: int, px: int):
    """The pixels a keypoint's bilinear taps read in one gradient plane:
    the distinct rows {y0, y0 + 1} times the distinct columns of its grid
    of in-patch positions, clamped 1 px inside the patch (chip_smoke.py
    `_sampled_px`)."""
    def distinct(u, p):
        u0 = torch.floor(u.clamp(1.0, p - 2.001))
        v = torch.sort(torch.cat([u0, u0 + 1], -1), -1).values
        return 1 + (v[..., 1:] != v[..., :-1]).sum(-1)

    return (distinct(ucy[..., None] + lin * radius[..., None], py)
            * distinct(ucx[..., None] + lin * radius[..., None], px))


def sift_counts(state: list) -> dict:
    """P3's and P4's counts for one SIFT detection call, from its keypoint
    state per octave (the refined keypoints' octave xy, layer and validity
    and the octave's size; the output slots' sources): chip_smoke.py's
    counts over the valid keypoints only -- per keypoint the gradient
    pixels its 24 x 24 taps read in both planes (a keypoint and its
    secondary orientation read them once for P4), its scalars and outputs,
    and the samples' operations."""
    out = {}
    n_s = SIFT_GRID
    for st in state:
        h, w = st["shape"]
        py, px = min(80, h), min(80, w)
        xy, valid = st["xy"].double(), st["valid"].bool()
        scl = 1.6 * torch.pow(2.0, st["lay"].double() / 3.0)
        x0 = (torch.round(xy[..., 0]) - px // 2).clamp(0, w - px)
        y0 = (torch.round(xy[..., 1]) - py // 2).clamp(0, h - py)
        ucx, ucy = xy[..., 0] - x0, xy[..., 1] - y0
        half = (24 - 1) / 2.0
        lin_o = (torch.arange(24, dtype=torch.float64,
                              device=xy.device) - half) / half
        lin_d = (torch.arange(24, dtype=torch.float64,
                              device=xy.device) + 0.5) / 24 * 2.0 - 1.0
        n_o = _sampled_px(ucx, ucy, 4.5 * scl, lin_o, py, px)
        nv = float(valid.sum())
        add(out, {"P3": (float(n_o[valid].sum()) * 8 + nv * (3 + 36) * 4,
                         nv * n_s * P3_OPS_PER_SAMPLE, FP32_OPS_PER_S)})
        pidx = st["pidx"]
        slot_ok = torch.gather(valid, 1, pidx)
        n_d = _sampled_px(ucx, ucy, scl * 3.0 * math.sqrt(2.0) * 2.5, lin_d,
                          py, px)
        src = torch.zeros_like(valid)
        src.scatter_(1, pidx, slot_ok)
        ns = float(slot_ok.sum())
        add(out, {"P4": (float(n_d[src].sum()) * 8
                         + ns * (4 * 4 + 8 + 128 * 4),
                         ns * (n_s * P4_OPS_PER_SAMPLE + P4_OPS_PER_SLOT),
                         FP32_OPS_PER_S)})
    return out
