"""Batched-hypothesis RANSAC for the essential matrix
(port of rpe_tpu/geometry/ransac.py).

Per pair: NUM_HYPOTHESES minimal samples from the valid matches (threefry
draws, ops bit-equal to the reference), the 5-point (or 8-point) solver on
all of them at once, Sampson scoring of every hypothesis against every
match, count-then-cheirality-then-MSAC selection, optionally LO-RANSAC's
local optimisation, least-squares refits, and optionally the DEGENSAC rescue
and the ambiguity blend. Every tensor carries a leading pair axis P.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import rng
from ..utils.observability import htod
from .epipolar import eight_point, project_to_essential, sampson_error_sq


def sample_minimal_indices(key, valid_mask, num_hypotheses, sample_size=8):
    """Uniform `sample_size`-draws from the valid correspondences: key
    (P, 2), valid_mask (P, N) -> (P, H, S) int64 indices. Valid indices are
    compacted to the front by a stable sort, then each slot draws
    uniformly over [0, num_valid)."""
    order = torch.argsort((~valid_mask).to(torch.uint8), dim=-1, stable=True)
    num_valid = valid_mask.sum(-1, dtype=torch.int32)                # (P,)
    u = rng.uniform(key, (num_hypotheses, sample_size))            # (P, H, S)
    slot = torch.minimum((u * num_valid[:, None, None]).to(torch.int32),
                         torch.clamp_min(num_valid - 1, 0)[:, None, None])
    p = order.shape[0]
    return torch.gather(order, 1, slot.reshape(p, -1).long()).reshape(
        slot.shape)


def gather_points(pts, idx):
    """pts (P, N, 2) at idx (P, ...) -> (P, ..., 2)."""
    p = pts.shape[0]
    flat = idx.reshape(p, -1)
    out = torch.gather(pts, 1, flat[..., None].expand(-1, -1, 2))
    return out.reshape(*idx.shape, 2)


# LO-RANSAC's annealed threshold multipliers, in float32 as the reference's
LO_MULTIPLIERS = np.array([4.0, 2.0, 1.4142135, 1.0], np.float32)


def _truncated_loss(E, pts1_n, pts2_n, valid_f, thr2):
    """Truncated MSAC loss sum(min(d2, thr2)) over the valid matches, a
    non-finite residual counting as thr2: E (P, ..., 3, 3), pts (P, N, 2)
    broadcast against E's middle axes, valid_f (P, N) float, thr2
    broadcastable to the residuals (P, ..., N)."""
    extra = E.dim() - 3
    shape = (pts1_n.shape[0],) + (1,) * extra + pts1_n.shape[1:]
    d2 = sampson_error_sq(E, pts1_n.reshape(shape), pts2_n.reshape(shape))
    d2 = torch.where(torch.isfinite(d2), d2, thr2)
    return (torch.minimum(d2, thr2)
            * valid_f.reshape(shape[:-1])).sum(-1)


def local_optimization(key, E_best, inlier_mask, pts1_n, pts2_n, valid_mask,
                       thr2):
    """LO-RANSAC (Lebeda, Chum, Matas, BMVC 2012) on the winner of each
    pair, as the reference runs it (rpe_tpu/geometry/ransac.py:179-233):
    8 weighted 8-point fits on 16 points drawn from the winner's inliers
    (`sample_minimal_indices` with fold_in(key, 11)), the best of those and
    the winner by truncated MSAC loss, then weighted 8-point refits at the
    thresholds thr2 * LO_MULTIPLIERS, each taken when it has >= 8 points
    and does not raise the loss at thr2. thr2 (P, 1). Returns (E (P, 3, 3),
    inlier_mask (P, N)) of the result at thr2."""
    p, n = valid_mask.shape
    dt = pts1_n.dtype
    ar = torch.arange(p, device=pts1_n.device)
    valid_f = valid_mask.to(dt)
    in_idx = sample_minimal_indices(rng.fold_in(key, 11), inlier_mask, 8,
                                    sample_size=16)                # (P, 8, 16)
    w_in = torch.zeros((p, 8, n), dtype=dt, device=pts1_n.device)
    w_in.scatter_(2, in_idx, 1.0)
    E_in = eight_point(pts1_n[:, None], pts2_n[:, None],
                       weights=w_in * valid_f[:, None])
    E_in, _, _ = project_to_essential(E_in)
    E_cand = torch.cat([E_best[:, None], E_in], dim=1)            # (P, 9)
    loss_cand = _truncated_loss(E_cand, pts1_n, pts2_n, valid_f,
                                thr2[:, :, None])
    ci = torch.argmin(loss_cand, dim=-1)
    E_cur, loss_cur = E_cand[ar, ci], loss_cand[ar, ci]
    for mult in htod(LO_MULTIPLIERS, pts1_n.device):
        thr_m = thr2 * mult
        d2c = sampson_error_sq(E_cur, pts1_n, pts2_n)
        d2c = torch.where(torch.isfinite(d2c), d2c, thr_m)
        w = ((d2c < thr_m) & valid_mask).to(dt)
        enough = w.sum(-1) >= 8
        E_new, _, _ = project_to_essential(eight_point(pts1_n, pts2_n,
                                                       weights=w))
        loss_new = _truncated_loss(E_new, pts1_n, pts2_n, valid_f, thr2)
        take = enough & (loss_new <= loss_cur)
        E_cur = torch.where(take[:, None, None], E_new, E_cur)
        loss_cur = torch.where(take, loss_new, loss_cur)
    d2b = sampson_error_sq(E_cur, pts1_n, pts2_n)
    d2b = torch.where(torch.isfinite(d2b), d2b, thr2)
    return E_cur, (d2b < thr2) & valid_mask


def hypotheses(key, pts1_n, pts2_n, valid_mask, num_hypotheses: int,
               solver: str):
    """Minimal-sample hypotheses projected to the essential manifold:
    E_h (P, Hh, 3, 3) and hyp_ok (P, Hh), Hh = num_hypotheses * MAX_ROOTS
    for the 5-point solver, num_hypotheses for the 8-point one."""
    p = valid_mask.shape[0]
    if solver == "5pt":
        from .five_point import five_point_essential

        idx = sample_minimal_indices(key, valid_mask, num_hypotheses,
                                     sample_size=5)
        E_r, root_ok = five_point_essential(gather_points(pts1_n, idx),
                                            gather_points(pts2_n, idx))
        E_h = E_r.reshape(p, -1, 3, 3)
        hyp_ok = root_ok.reshape(p, -1)
    elif solver == "8pt":
        idx = sample_minimal_indices(key, valid_mask, num_hypotheses)
        E_h = eight_point(gather_points(pts1_n, idx),
                          gather_points(pts2_n, idx))
        hyp_ok = torch.ones(E_h.shape[:2], dtype=torch.bool,
                            device=E_h.device)
    else:
        raise ValueError(f"Unknown solver: {solver}")
    E_h, _, _ = project_to_essential(E_h)
    return E_h, hyp_ok


def score_hypotheses(E_h, hyp_ok, pts1_n, pts2_n, valid_mask, thr2):
    """Every hypothesis against every match: inliers_h (P, Hh, N), the
    inlier counts (P, Hh) and the truncated MSAC sums (P, Hh); thr2
    (P, 1, 1)."""
    d2 = sampson_error_sq(E_h, pts1_n[:, None], pts2_n[:, None])  # (P,H,N)
    d2 = torch.where(torch.isfinite(d2), d2, thr2)
    inliers_h = (d2 < thr2) & valid_mask[:, None] & hyp_ok[..., None]
    counts = inliers_h.to(torch.int64).sum(-1)                    # (P, H)
    trunc = (torch.minimum(d2, thr2) * valid_mask[:, None]).sum(-1)
    return inliers_h, counts, trunc


def select_winner(E_h, inliers_h, counts, trunc, pts1_n, pts2_n):
    """Each pair's winning hypothesis (P,) and the hypotheses' scores
    (P, Hh): the MSAC tie-break by exact rank of the truncated loss, then a
    lexicographic selection among the top 8 -- count, cheirality votes
    over each hypothesis's own inliers, then the truncated loss."""
    from ..ops.orb import top_k_stable
    from .recover_pose import cheirality_votes

    p, n = inliers_h.shape[0], inliers_h.shape[-1]
    ar = torch.arange(p, device=E_h.device)
    hh = trunc.shape[-1]
    trunc_rank = torch.argsort(torch.argsort(trunc, dim=-1, stable=True),
                               dim=-1, stable=True)
    score = counts * hh - trunc_rank

    k = min(8, hh)
    _, top_idx = top_k_stable(score, k)
    arc = ar[:, None]
    votes_top = cheirality_votes(E_h[arc, top_idx], pts1_n[:, None],
                                 pts2_n[:, None], inliers_h[arc, top_idx])
    sel = counts[arc, top_idx] * (n + 1) + votes_top
    tied_trunc = torch.where(sel == sel.amax(-1, keepdim=True),
                             trunc[arc, top_idx], torch.inf)
    return top_idx[ar, torch.argmin(tied_trunc, dim=-1)], score


def refit_round(E_best, inlier_mask, pts1_n, pts2_n, valid_mask, thr2):
    """One least-squares refit on the current inliers, taken when it has
    >= 8 points and keeps at least as many inliers; thr2 (P, 1)."""
    w = inlier_mask.to(pts1_n.dtype)
    enough = inlier_mask.sum(-1, dtype=torch.int32) >= 8
    E_new = eight_point(pts1_n, pts2_n, weights=w)
    E_new, _, _ = project_to_essential(E_new)
    d2_new = sampson_error_sq(E_new, pts1_n, pts2_n)
    mask_new = (d2_new < thr2) & valid_mask
    better = (mask_new.sum(-1, dtype=torch.int32)
              >= inlier_mask.sum(-1, dtype=torch.int32))
    take = enough & better
    return (torch.where(take[:, None, None], E_new, E_best),
            torch.where(take[:, None], mask_new, inlier_mask))


def ransac_essential(key, pts1_n, pts2_n, valid_mask, threshold_n,
                     num_hypotheses: int = 2048, refit_rounds: int = 2,
                     solver: str = "8pt", degensac: bool = False,
                     lo: bool = False):
    """Batched-hypothesis essential-matrix RANSAC over P pairs.

    key (P, 2); pts (P, N, 2) normalized coords; valid_mask (P, N);
    threshold_n (P,) Sampson threshold in normalized units; `lo` runs
    `local_optimization` on the winner before the refits. Returns dict
    with E (P, 3, 3), inlier_mask (P, N), num_inliers (P,), ok (P,).
    """
    p = valid_mask.shape[0]
    ar = torch.arange(p, device=pts1_n.device)
    num_valid = valid_mask.sum(-1, dtype=torch.int32)

    E_h, hyp_ok = hypotheses(key, pts1_n, pts2_n, valid_mask,
                             num_hypotheses, solver)
    thr2 = (threshold_n * threshold_n)[:, None, None]             # (P,1,1)
    inliers_h, counts, trunc = score_hypotheses(E_h, hyp_ok, pts1_n, pts2_n,
                                                valid_mask, thr2)
    best, score = select_winner(E_h, inliers_h, counts, trunc, pts1_n,
                                pts2_n)

    E_best = E_h[ar, best]
    inlier_mask = inliers_h[ar, best]
    thr2 = thr2[:, 0]                                              # (P, 1)
    if lo:
        E_best, inlier_mask = local_optimization(
            key, E_best, inlier_mask, pts1_n, pts2_n, valid_mask, thr2)

    for _ in range(refit_rounds):
        E_best, inlier_mask = refit_round(E_best, inlier_mask, pts1_n,
                                          pts2_n, valid_mask, thr2)

    num_inliers = inlier_mask.sum(-1, dtype=torch.int32)

    if degensac:
        from .ambiguity import ambiguity_blend
        from .homography import degensac_rescue

        E_best, inlier_mask, num_inliers, used_pp, _ = degensac_rescue(
            rng.fold_in(key, 7), E_best, inlier_mask, num_inliers,
            pts1_n, pts2_n, valid_mask, threshold_n)
        E_bl, mask_bl, n_bl, _ = ambiguity_blend(
            E_h, score, counts, inliers_h, pts1_n, pts2_n, valid_mask,
            threshold_n, E_best, inlier_mask, num_inliers)
        E_best = torch.where(used_pp[:, None, None], E_best, E_bl)
        inlier_mask = torch.where(used_pp[:, None], inlier_mask, mask_bl)
        num_inliers = torch.where(used_pp, num_inliers, n_bl)

    min_valid = 5 if solver == "5pt" else 8
    ok = (num_valid >= min_valid) & (num_inliers >= 5)
    return {"E": E_best, "inlier_mask": inlier_mask,
            "num_inliers": num_inliers, "ok": ok}
