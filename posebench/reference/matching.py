"""Plain reference of the matching layer: cross-checked nearest neighbours
over the program's own descriptors, float64.

The matcher's semantics (the reference repo's BFMatcher with crossCheck,
as the port states them): over valid descriptors only, each row's nearest
column and each column's nearest row, the lowest index winning a tie; a row
is kept when the two agree; the kept rows are taken in ascending distance,
the lowest row first among equal distances, up to `max_matches`.

Numbers:
  match_off  slots whose (idx1, idx2, valid) differ from the reference's
             selection (a count; exact for Hamming distances, which are
             integers)
  match_gap  for float descriptors: the widest margin by which the
             program's selection departs from the reference's -- a match
             that is not mutual (its distance above its row's or column's
             minimum), or a mutual pair the program left out that it should
             have taken (its margin to the runner-up in its row and column,
             and to the largest distance the program selected when the cap
             was reached)
Nothing here imports the program.
"""

from __future__ import annotations

import torch

F64 = torch.float64
BIG = 1e300


def distances(d1, d2, norm: str, dtype=F64):
    """Pairwise distances (N1, N2): Hamming of {0, 1} bits, or squared L2
    of float descriptors, in `dtype`."""
    a, b = d1.to(dtype), d2.to(dtype)
    if norm == "hamming":
        return a.sum(1)[:, None] + b.sum(1)[None] - 2.0 * (a @ b.T)
    return torch.clamp_min((a * a).sum(1)[:, None] + (b * b).sum(1)[None]
                           - 2.0 * (a @ b.T), 0.0)


def cross_check(D, v1, v2, max_matches: int):
    """(idx1, idx2, valid) (max_matches,) of the reference selection over
    the float64 distance matrix D (N1, N2)."""
    D = torch.where(v1[:, None] & v2[None], D.to(F64),
                    torch.full((), BIG, dtype=F64, device=D.device))
    nn12 = torch.argmin(D, dim=1)
    nn21 = torch.argmin(D, dim=0)
    best = D.gather(1, nn12[:, None])[:, 0]
    rows = torch.arange(D.shape[0], device=D.device)
    keep = (nn21[nn12] == rows) & v1 & (best < BIG)
    cand = torch.where(keep, best, torch.full_like(best, BIG))
    order = torch.sort(cand, stable=True).indices[:max_matches]
    valid = cand[order] < BIG
    idx1 = torch.where(valid, order, torch.zeros_like(order))
    idx2 = torch.where(valid, nn12[order], torch.zeros_like(order))
    n = order.shape[0]
    if n < max_matches:
        pad = torch.zeros(max_matches - n, dtype=order.dtype,
                          device=D.device)
        idx1, idx2 = torch.cat([idx1, pad]), torch.cat([idx2, pad])
        valid = torch.cat([valid, pad.bool()])
    return idx1, idx2, valid


def match_off(m: dict, d1, d2, v1, v2, norm: str, max_matches: int) -> int:
    """Slots of the program's matches m (idx1, idx2, valid) that differ
    from the reference selection."""
    r1, r2, rv = cross_check(distances(d1, d2, norm), v1, v2, max_matches)
    pv = m["valid"].bool()
    diff = (pv != rv) | (pv & ((m["idx1"].long() != r1)
                               | (m["idx2"].long() != r2)))
    return int(diff.sum())


def match_gap(m: dict, d1, d2, v1, v2, norm: str, max_matches: int) -> float:
    """The widest margin by which the program's selection departs from the
    reference's (0 where they agree)."""
    D = distances(d1, d2, norm)
    D = torch.where(v1[:, None] & v2[None], D,
                    torch.full((), BIG, dtype=F64, device=D.device))
    pv = m["valid"].bool()
    i, j = m["idx1"].long()[pv], m["idx2"].long()[pv]
    gap = 0.0
    if i.numel():
        dij = D[i, j]
        g = torch.maximum(dij - D[i].min(1).values, dij - D[:, j].min(0).values)
        gap = max(gap, float(g.max()))
    r1, r2, rv = cross_check(D, v1, v2, D.shape[0])
    r1, r2 = r1[rv], r2[rv]
    taken = torch.zeros_like(D, dtype=torch.bool)
    taken[i, j] = True
    missed = ~taken[r1, r2]
    if bool(missed.any()):
        a, b = r1[missed], r2[missed]
        d = D[a, b]
        row2 = torch.topk(D[a], 2, dim=1, largest=False).values[:, 1]
        col2 = torch.topk(D[:, b], 2, dim=0, largest=False).values[1]
        margin = torch.minimum(row2 - d, col2 - d)
        if int(pv.sum()) >= max_matches:
            margin = torch.minimum(margin, D[i, j].max() - d)
        gap = max(gap, float(margin.max()))
    return gap


def control(d1, d2, v1, v2, norm: str, max_matches: int) -> dict:
    """The control's matches: the reference selection over distances
    computed in bfloat16, the next precision below float32."""
    D = distances(d1, d2, norm, dtype=torch.bfloat16)
    i1, i2, v = cross_check(D, v1, v2, max_matches)
    return {"idx1": i1, "idx2": i2, "valid": v}
