"""A run of the harness on the CPU at a tiny size -- the look for a card
skipped, everything else as on the card -- with the timed path broken
underneath: `correct` has to come out false for each fault a cell can have.
The cells run on one card, so there is no exchange between chips to leave
out. A sound run and the control (the reference in bfloat16 in the
program's place) are read on the same tiny cell.

    python3 -m pytest posebench/tests
"""

import json
import time

import pytest
import torch

from helpers import load_cell, small_runs, tiny_checkout


@pytest.fixture(scope="module", autouse=True)
def short_runs():
    with small_runs(CHECK_PAIRS=4):
        yield


@pytest.fixture(scope="module")
def orb_cell(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("orb")
    name = tiny_checkout(tmp, pairs=4)
    return load_cell(tmp, name)


@pytest.fixture(scope="module")
def sift_cell(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sift")
    name = tiny_checkout(tmp, config="sift", height=120, width=400, fx=231.7,
                         fy=231.7, cx=200.0, cy=60.0, pairs=2)
    return load_cell(tmp, name)


def run(cell, control=False):
    import harness

    torch.manual_seed(0)
    return harness.run(cell, 2 ** 31 + 11, 0.5, False, "cpu",
                       time.perf_counter(), log=lambda m: None,
                       control=control)


def failed(result):
    """The numbers over their limits; every number where the check could
    not read the window's outputs."""
    return sorted(k for k, v in result["checks"].items()
                  if v["value"] is None or v["value"] > v["limit"])


@pytest.fixture
def est():
    from rpe_tpu_torch.pipeline import estimator

    saved = dict(vars(estimator))
    yield estimator
    for k in ("estimate_sequence_batched", "_match_to_pose",
              "detect_features"):
        setattr(estimator, k, saved[k])


@pytest.fixture
def patch(monkeypatch):
    """Replace a function of a module of the program for one test."""
    import importlib

    def put(module, name, fn):
        monkeypatch.setattr(importlib.import_module(module), name, fn)

    return put


def test_sound_run_and_control(orb_cell):
    r = run(orb_cell, control=True)
    assert r["correct"], r["checks"]
    ctl = {k: r["control"][k] > v["limit"] for k, v in r["checks"].items()}
    for k in ("brief_gap", "inlier_gap", "harris_gap", "fast_gap",
              "select_gap"):
        assert ctl[k], (k, r["control"])
    json.dumps(r)


def test_fast_skipped(orb_cell, patch):
    """K1's rank map with Harris at every pixel, FAST and its non-max
    suppression left out."""
    from rpe_tpu_torch.ops import fast

    real = fast.fast_harris_rank_map

    def no_fast(img, threshold=15.0, k_harris=0.04):
        _, blur = real(img, threshold, k_harris)
        return fast.harris_response_map(img, k=k_harris), blur

    patch("rpe_tpu_torch.ops.fast", "fast_harris_rank_map", no_fast)
    r = run(orb_cell)
    assert not r["correct"] and "fast_gap" in failed(r)


def test_weakest_kept(orb_cell, patch):
    """Each level's top-k taken over the negated responses: the weakest
    candidates kept."""
    from rpe_tpu_torch.ops import fast

    real = fast.fast_harris_rank_map

    def weakest(img, threshold=15.0, k_harris=0.04):
        rank, blur = real(img, threshold, k_harris)
        return torch.where(torch.isfinite(rank), -rank, rank), blur

    patch("rpe_tpu_torch.ops.fast", "fast_harris_rank_map", weakest)
    r = run(orb_cell)
    assert not r["correct"] and "select_gap" in failed(r)


def test_keypoints_dropped(orb_cell, patch):
    """Every fourth keypoint of the selection made invalid before the
    extraction bands."""
    from rpe_tpu_torch.ops import orb

    real = orb.atlas_keypoints

    def dropped(*a, **k):
        out = dict(real(*a, **k))
        v = out["valid"].clone()
        v[:, ::4] = False
        out["valid"] = v
        return out

    patch("rpe_tpu_torch.ops.orb", "atlas_keypoints", dropped)
    r = run(orb_cell)
    assert not r["correct"] and "select_gap" in failed(r)


def test_pose_wrong_but_consistent(orb_cell, est):
    """Every R turned by 0.5 degrees where it is produced, with the inlier
    mask, count and validity made again under the turned pose: a wrong
    model that agrees with itself. (The 5-point solver's roots broken --
    scaled by 1.5, shifted by 0.5, x and y swapped -- moved a tiny cell's
    poses by little: RANSAC's refits recover the model.)"""
    from reference import pose as ref

    real = est._match_to_pose
    a = torch.tensor(0.5 * torch.pi / 180.0, dtype=torch.float64)
    turn = torch.tensor([[torch.cos(a), 0.0, torch.sin(a)], [0.0, 1.0, 0.0],
                         [-torch.sin(a), 0.0, torch.cos(a)]],
                        dtype=torch.float64)

    def altered(det1, det2, K, keys, cfg):
        out = dict(real(det1, det2, K, keys, cfg))
        Kd = torch.as_tensor(K, dtype=torch.float64)
        thr = cfg.ransac.threshold_px / (0.5 * float(Kd[0, 0] + Kd[1, 1]))
        R = turn @ out["R"].double()
        masks = []
        for p in range(R.shape[0]):
            d2 = ref.sampson_sq(ref.skew(out["t"][p].double()) @ R[p],
                                ref.normalize(out["pts1"][p].double(), Kd),
                                ref.normalize(out["pts2"][p].double(), Kd))
            masks.append((d2 < thr * thr) & out["match_valid"][p].bool())
        m = torch.stack(masks)
        n = m.sum(1)
        out.update(R=R.to(out["R"].dtype), inlier_mask=m,
                   num_inliers=n.to(out["num_inliers"].dtype),
                   valid=(out["num_matches"] >= 5) & (n >= 5))
        return out

    est._match_to_pose = altered
    r = run(orb_cell)
    assert not r["correct"] and "inlier_short" in failed(r), r["checks"]


def test_state_returned_unchanged(orb_cell, est):
    """Each call returns what the call before it returned."""
    real = est.estimate_sequence_batched
    last = []

    def stale(*a, **k):
        out = real(*a, **k)
        last.append(out)
        return last[-2] if len(last) > 1 else out

    est.estimate_sequence_batched = stale
    r = run(orb_cell)
    assert not r["correct"] and "pose_off" in failed(r)


def test_half_the_batch_left_out(orb_cell, est):
    """Matching and pose on the first half of the pairs only, the rest
    given the first half's answers."""
    real = est._match_to_pose

    def half(det1, det2, K, keys, cfg):
        n = det1["valid"].shape[0]
        h = -(-n // 2)
        out = real({k: v[:h] for k, v in det1.items()},
                   {k: v[:h] for k, v in det2.items()}, K, keys[:h], cfg)
        idx = torch.arange(n) % h
        return {k: v[idx] for k, v in out.items()}

    est._match_to_pose = half
    r = run(orb_cell)
    assert not r["correct"] and "pose_off" in failed(r)


def test_pose_altered(orb_cell, est):
    """Every R turned by 0.2 degrees where it is produced."""
    real = est._match_to_pose
    c, s = torch.cos(torch.tensor(0.0035)), torch.sin(torch.tensor(0.0035))
    turn = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])

    def altered(*a):
        out = real(*a)
        out["R"] = turn @ out["R"]
        return out

    est._match_to_pose = altered
    r = run(orb_cell)
    assert not r["correct"] and "inlier_gap" in failed(r)


def test_descriptor_altered(orb_cell, est):
    """One bit of every keypoint's descriptor flipped where it is made."""
    real = est.detect_features

    def altered(imgs, cfg):
        out = dict(real(imgs, cfg))
        bits = out["bits"].clone()
        bits[..., 17] ^= 1
        out["bits"] = bits
        return out

    est.detect_features = altered
    r = run(orb_cell)
    assert not r["correct"] and "brief_gap" in failed(r)


def test_sift_sound_run_and_control(sift_cell):
    r = run(sift_cell, control=True)
    assert r["correct"], r["checks"]
    for k in ("scale_gap", "refine_gap", "ori_gap", "desc_gap",
              "inlier_gap", "ext_gap", "test_gap"):
        assert r["control"][k] > r["checks"][k]["limit"], (k, r["control"])


def test_sift_strongest_extrema_left_out(sift_cell, patch):
    """Each octave's selection made without its strongest quarter of
    extrema."""
    from rpe_tpu_torch.ops import orb

    def weakest(vals, quota, select="exact"):
        n = int((vals > 0).sum(1).max())
        top = orb.top_k_stable(vals, max(n // 4, 1))[1]
        return orb.top_k_stable(vals.scatter(1, top, 0.0), quota)

    patch("rpe_tpu_torch.ops.sift", "select_candidates", weakest)
    r = run(sift_cell)
    assert not r["correct"] and "ext_gap" in failed(r)


def test_sift_tests_skipped(sift_cell, patch):
    """The refinement's contrast and edge tests left out: every selected
    extremum that converged kept."""
    from rpe_tpu_torch.ops import sift

    real = sift.refine_candidates

    def untested(D, scores0, flat):
        xy, lay, score, valid, kint = real(D, scores0, flat)
        keep = valid | (scores0 > 0)
        return xy, lay, torch.where(keep, scores0, score), keep, kint

    patch("rpe_tpu_torch.ops.sift", "refine_candidates", untested)
    r = run(sift_cell)
    assert not r["correct"] and "test_gap" in failed(r)


def test_sift_descriptor_altered(sift_cell, est):
    """Each SIFT descriptor's first two values swapped where it is made."""
    real = est.detect_features

    def altered(imgs, cfg):
        out = dict(real(imgs, cfg))
        d = out["desc"].clone()
        d[..., [0, 1]] = d[..., [1, 0]]
        d[..., 5] += 0.05
        out["desc"] = d
        return out

    est.detect_features = altered
    r = run(sift_cell)
    assert not r["correct"] and "desc_gap" in failed(r)
