"""Sharded estimation: sequence blocks over a 'pairs' mesh, and pair-DP x
hypothesis-parallel RANSAC over a ('pairs', 'hyp') mesh (port of
rpe_tpu/parallel/sharded_estimator.py).

The workload's natural axis is pair-level data parallelism. For single
huge pairs -- or to use more devices than there are pairs -- the RANSAC
hypothesis batch is the second shardable axis: each device along 'hyp'
evaluates num_hypotheses / n_hyp minimal samples (with a fold_in'd key),
and the winning model is the one with the most inliers across them.

One controller drives the devices in turn (mesh.py). Each device's work
is queued before any result is read, but the estimator's own host syncs
(stream synchronisations in the glue between its kernels) still
serialise the shards across cards.
"""

from __future__ import annotations

import torch

from .. import rng
from ..config import EstimatorConfig
from ..geometry.epipolar import normalize_points, sampson_error_sq
from ..geometry.ransac import ransac_essential
from ..geometry.recover_pose import recover_pose
from ..pipeline.estimator import _prepare, _tensor, detect_features, \
    estimate_sequence_batched, match_features, zero_motion_gate
from ..utils.observability import htod
from .mesh import pair_pieces


def _need_axes(mesh, names):
    if mesh.axis_names != names:
        raise ValueError(f"want a mesh with axes {names}, got "
                         f"{mesh.axis_names}")


def _gather(outs, dev, join):
    """Per-shard output dicts -> one dict on `dev`, joined by `join`."""
    return {k: join([o[k].to(dev, non_blocking=True) for o in outs])
            for k in outs[0]}


def _estimate_pair_hyp_sharded(imgs1, imgs2, K, keys, cfg: EstimatorConfig,
                               hyp_devices):
    """Estimate of P pairs with the hypothesis axis sharded over
    `hyp_devices` (one 'pairs' position of the mesh).

    Detection and matching run once, on the first hyp device; the
    reference repeats them on every hyp device only because shard_map
    must, and its result is the same. Each hyp device h runs RANSAC with
    the pairs' keys folded with h on num_hypotheses / n_hyp (at least 8)
    samples; the winner is the first device with the most inliers (the
    reference's argmax over its all_gather), and its inliers are
    recomputed here.
    """
    dev, K, keys = _prepare(hyp_devices[0], K, keys)
    imgs1 = _tensor(imgs1, dev, torch.float32)
    imgs2 = _tensor(imgs2, dev, torch.float32)
    p = imgs1.shape[0]
    dets = detect_features(torch.cat([imgs1, imgs2]), cfg)
    det1 = {k: v[:p] for k, v in dets.items()}
    det2 = {k: v[p:] for k, v in dets.items()}
    matches = match_features(det1, det2, cfg)
    pts1 = torch.gather(det1["xy"], 1,
                        matches["idx1"][..., None].expand(-1, -1, 2))
    pts2 = torch.gather(det2["xy"], 1,
                        matches["idx2"][..., None].expand(-1, -1, 2))
    mvalid = matches["valid"]
    num_matches = mvalid.sum(-1, dtype=torch.int32)

    n1 = normalize_points(pts1, K)
    n2 = normalize_points(pts2, K)
    thr_n = cfg.ransac.threshold_px / (0.5 * (K[0, 0] + K[1, 1]))
    local_h = max(cfg.ransac.num_hypotheses // len(hyp_devices), 8)
    rs = []
    for h, hd in enumerate(hyp_devices):
        rs.append(ransac_essential(
            rng.fold_in(keys, h).to(hd), n1.to(hd), n2.to(hd),
            mvalid.to(hd), thr_n.expand(p).to(hd),
            num_hypotheses=local_h,
            refit_rounds=cfg.ransac.refit_rounds,
            solver=cfg.ransac.solver,
            degensac=cfg.ransac.degensac))
    # the winner across the hypothesis shards: torch.argmax takes the
    # first of equal maxima, as jnp.argmax does
    counts = torch.stack([r["num_inliers"].to(dev) for r in rs], dim=1)
    Es = torch.stack([r["E"].to(dev) for r in rs], dim=1)      # (P, n, 3, 3)
    E = Es[torch.arange(p, device=dev), torch.argmax(counts, dim=1)]
    inlier_mask = (sampson_error_sq(E, n1, n2) < thr_n * thr_n) & mvalid
    num_inliers = inlier_mask.sum(-1, dtype=torch.int32)
    # the solver-aware gate of ransac_essential
    min_valid = 5 if cfg.ransac.solver == "5pt" else 8
    ok = (num_matches >= min_valid) & (num_inliers >= 5)
    R, t, votes, _ = recover_pose(E, n1, n2, mvalid, inlier_mask=inlier_mask)

    valid = ok & (num_matches >= 5)
    if cfg.ransac.zero_motion_px > 0.0:
        zm = zero_motion_gate(pts1, pts2, mvalid, num_matches,
                              cfg.ransac.zero_motion_px)
        valid = valid | zm
    else:
        zm = torch.zeros_like(valid)
    use = valid & ~zm
    eye = torch.eye(3, dtype=R.dtype, device=dev)
    t001 = htod([0.0, 0.0, 1.0], dev, t.dtype)
    return {
        "R": torch.where(use[:, None, None], R, eye),
        "t": torch.where(use[:, None], t, t001),
        "valid": valid,
        "num_matches": num_matches, "num_inliers": num_inliers,
        "cheirality_votes": votes,
    }


def estimate_sequence_sharded(frame_blocks, K, key_blocks,
                              cfg: EstimatorConfig, mesh):
    """Sequence-batched estimation sharded over a 1-D 'pairs' mesh.

    frame_blocks: (n_dev, local+1, H, W), whole or as `shard_pairs` split
      it -- device d holds the local+1 consecutive frames covering its
      `local` contiguous pairs (one overlapping boundary frame per device)
      and detects each of them once for both of its pairs
      (pipeline/estimator.estimate_sequence_batched).
    key_blocks: (n_dev, local, 2) threefry keys, one per pair.

    Every device's work is queued before any result is read. Returns the
    estimate_sequence_batched output dict with a leading (n_dev, local,
    ...) shape on the mesh's first device; reshape to (n_dev*local, ...)
    for the flat pair axis. Blocks are self-contained: nothing crosses
    devices but the outputs.
    """
    _need_axes(mesh, ("pairs",))
    with torch.no_grad():
        outs = [estimate_sequence_batched(f[0], K, k[0], cfg=cfg, device=d)
                for d, f, k in zip(mesh.devices.flat,
                                   pair_pieces(mesh, frame_blocks),
                                   pair_pieces(mesh, key_blocks))]
        return _gather(outs, mesh.devices.flat[0], torch.stack)


def estimate_pairs_2d(imgs1, imgs2, K, keys, cfg: EstimatorConfig, mesh):
    """Batched pair estimation over a 2-D ('pairs', 'hyp') mesh.

    imgs1/imgs2: (B, H, W), whole or as `shard_pairs` split them, with B
    divisible by the 'pairs' axis size; keys (B, 2). Each 'pairs' position
    estimates its pairs with their hypotheses split over its 'hyp'
    devices. Returns the per-pair dict with a leading B axis on the mesh's
    first device.
    """
    _need_axes(mesh, ("pairs", "hyp"))
    with torch.no_grad():
        outs = [_estimate_pair_hyp_sharded(a, b, K, k, cfg, list(row))
                for row, a, b, k in zip(mesh.devices,
                                        pair_pieces(mesh, imgs1),
                                        pair_pieces(mesh, imgs2),
                                        pair_pieces(mesh, keys))]
        return _gather(outs, mesh.devices.flat[0], torch.cat)
