"""rpe_tpu_torch.pipeline.batch against rpe_tpu.pipeline.batch on the CPU,
from PNGs written to disk: pair estimation across two chunks with a padded
tail (5 frames, 4 pairs, chunk 3), process_sequence's GT anchoring, the
checkpoint cases of tests/test_checkpoint.py re-expressed on the port, the
inlier-collapse fallback of tests/test_fallback.py against the reference's
orb512 answers, and the options once refused (a device mesh, VP).

Config: tests/test_checkpoint.py's TINY (ORB-512 on 3 levels, 128 matches,
256 hypotheses). Contracts: `valid` and `num_matches` exactly; relative
rotations within 0.5 deg of the reference's, the bound
tests/test_torch_pipeline.py holds the same sequence path to (both run
float32 RANSAC, whose last-bit differences move R by up to ~0.01 deg on
these pairs); the GT anchoring and Euler conversion, fed the same relative
rotations, within 1e-4 deg.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

import rpe_tpu.config as jcfg
from rpe_tpu.io.image_loader import LazyFrameSource as JLazy
from rpe_tpu.pipeline import batch as jbatch
from rpe_tpu.pipeline.estimator import PoseEstimator as JEstimator
from rpe_tpu.pipeline.ground_truth import GroundTruthLoader as JGT
from rpe_tpu_torch import convert
from rpe_tpu_torch.io.image_loader import LazyFrameSource as TLazy
from rpe_tpu_torch.pipeline import batch as tbatch
from rpe_tpu_torch.pipeline.estimator import PoseEstimator as TEstimator
from rpe_tpu_torch.pipeline.ground_truth import GroundTruthLoader as TGT
from rpe_tpu_torch.utils.synthetic import make_sequence, rotation_error_deg, \
    write_png
from torch_gates import default_extraction_gates  # noqa: F401
from torch_gates import one_torch_thread  # noqa: F401

H, W = 188, 620
FRAMES = [0, 1, 2, 3, 4]
CHUNK = 3
TINY = jcfg.EstimatorConfig(
    orb=jcfg.OrbConfig(nfeatures=512, nlevels=3, max_kpts=512),
    matcher=jcfg.MatcherConfig(max_matches=128),
    ransac=jcfg.RansacConfig(num_hypotheses=256),
)
# tests/test_fallback.py's starved primary config
WEAK = jcfg.EstimatorConfig(
    orb=jcfg.OrbConfig(nfeatures=128, nlevels=2, max_kpts=128, band=8,
                       extract_cap=8),
    matcher=jcfg.MatcherConfig(max_matches=64),
    ransac=jcfg.RansacConfig(num_hypotheses=64),
)


def _port_cfg(cfg):
    return convert.config_from_dict(dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    """5 written frames (the scene's K) and a camera_poses.txt."""
    d = tmp_path_factory.mktemp("seq")
    frames, K, (R, _) = make_sequence(len(FRAMES), H, W, seed=4)
    for i, f in enumerate(frames):
        write_png(d / f"{i:06d}.png", np.clip(np.rint(f), 0, 255)
                  .astype(np.uint8))
    g = np.random.default_rng(2)
    rows = ["frame x y z roll pitch yaw"]
    for i in FRAMES:
        x, y, z = g.normal(size=3)
        r, p, yw = g.uniform(-20.0, 20.0, 3)
        rows.append(f"{i} {x:.6f} {y:.6f} {z:.6f} {r:.6f} {p:.6f} {yw:.6f}")
    (d / "camera_poses.txt").write_text("\n".join(rows) + "\n")
    return d, K, R


def _processors(seq, cfg=TINY, chunk=CHUNK, **kw):
    d, K, _ = seq
    jgt, tgt = JGT(d / "camera_poses.txt"), TGT(d / "camera_poses.txt")
    jgt.load()
    tgt.load()
    est_kw = dict(nfeatures=cfg.orb.nfeatures,
                  max_matches=cfg.matcher.max_matches)
    jp = jbatch.BatchProcessor(d, JEstimator(K, config=cfg, **est_kw), jgt,
                               chunk=chunk, **kw)
    tp = tbatch.BatchProcessor(
        d, TEstimator(K, config=_port_cfg(cfg), device="cpu", **est_kw), tgt,
        chunk=chunk, **kw)
    return jp, tp


@pytest.fixture(scope="module")
def runs(seq):
    """Both packages' process_sequence over the 5 frames, and the relative
    poses each estimated on the way."""
    jp, tp = _processors(seq)
    rel = {}
    for name, p in (("ref", jp), ("port", tp)):
        orig = p._estimate_all_pairs

        def keep(frames, imgs, orig=orig, name=name):
            rel[name] = orig(frames, imgs)
            return rel[name]

        p._estimate_all_pairs = keep
    return jp.process_sequence(FRAMES), tp.process_sequence(FRAMES), rel, \
        (jp, tp)


def test_config_hash_describes_the_same_run(seq):
    jp, tp = _processors(seq)
    assert repr(tp.pose_estimator.config) == repr(jp.pose_estimator.config)
    assert tp._config_hash() == jp._config_hash()


def test_estimate_relative_poses_matches_reference(seq, runs):
    _, _, rel, _ = runs
    (Rj, tj, vj, nj), (Rt, tt, vt, nt) = rel["ref"], rel["port"]
    assert Rt.shape == (4, 3, 3) and Rt.dtype == np.float64
    np.testing.assert_array_equal(vt, vj)
    assert vt.all()
    np.testing.assert_array_equal(nt, nj)
    assert rotation_error_deg(Rt, Rj).max() < 0.5
    assert rotation_error_deg(Rt, seq[2][None]).max() < 2.0
    # the same through estimate_relative_poses from a fresh frame source
    d = seq[0]
    _, tp = _processors(seq)
    paths = [str(d / f"{i:06d}.png") for i in FRAMES]
    again = tp.estimate_relative_poses(FRAMES, TLazy(paths))
    for a, b in zip(again, rel["port"]):
        np.testing.assert_array_equal(a, b)
    assert tp.timer.counts["dispatch"] == 2       # two chunks
    assert tp.meter.pairs == 4


def test_process_sequence_matches_reference(runs):
    ref, got, _, _ = runs
    assert got.keys() == ref.keys()
    assert got["frames"] == ref["frames"] == FRAMES[1:]
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    np.testing.assert_array_equal(got["num_matches"], ref["num_matches"])
    assert rotation_error_deg(np.stack(got["R"]),
                              np.stack(ref["R"])).max() < 0.5
    for k in ("roll", "pitch", "yaw"):
        assert got[k].dtype == ref[k].dtype == np.float32, k
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=0.5)
    for a, b in zip(got["t"], ref["t"]):
        assert a.shape == b.shape == (3, 1)


def test_gt_anchoring_in_float32_matches_reference(runs):
    """The anchoring alone, both packages fed the reference's relative
    poses: float32 GT rotations composed with float64 R_rel, Euler in
    float32, within 1e-4 deg; R within 1e-6."""
    _, _, rel, (jp, tp) = runs
    for conv in ("yup", "zyx"):
        out = []
        for p in (jp, tp):
            p.euler_convention = conv
            p._estimate_all_pairs = lambda frames, imgs: rel["ref"]
            out.append(p.process_sequence(FRAMES))
        ref, got = out
        for k in ("roll", "pitch", "yaw"):
            assert got[k].dtype == np.float32
            np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-4)
        np.testing.assert_allclose(np.stack(got["R"]), np.stack(ref["R"]),
                                   rtol=0, atol=1e-6)


@pytest.mark.parametrize("sel1,local,n_dev,last", [
    ([0, 1, 2, 3, 4, 5, 6, 7], 2, 4, 9),
    ([8, 9, 10, 10, 10, 10], 3, 2, 11),
    ([5, 5, 5, 5], 1, 4, 5),
])
def test_sequence_blocks_equal(sel1, local, n_dev, last):
    np.testing.assert_array_equal(
        tbatch._sequence_blocks(sel1, local, n_dev, last),
        jbatch._sequence_blocks(sel1, local, n_dev, last))


# ---- checkpoints (tests/test_checkpoint.py, on the port) --------------------

def _port_processor(seq, ckpt, cfg=TINY):
    d, K, _ = seq
    gt = TGT(d / "camera_poses.txt")
    gt.load()
    est = TEstimator(K, nfeatures=cfg.orb.nfeatures,
                     max_matches=cfg.matcher.max_matches,
                     config=_port_cfg(cfg), device="cpu")
    return tbatch.BatchProcessor(d, est, gt, chunk=2, checkpoint_path=ckpt)


@pytest.fixture()
def count_calls(monkeypatch):
    calls = []
    orig = tbatch.estimate_sequence_batched

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    monkeypatch.setattr(tbatch, "estimate_sequence_batched", counted)
    return calls


def test_checkpoint_resume_skips_computation(seq, tmp_path, count_calls):
    ckpt = tmp_path / "ckpt.jsonl"
    r1 = _port_processor(seq, ckpt).process_sequence(FRAMES)
    lines = ckpt.read_text().splitlines()
    assert len(lines) == 5                  # config-hash header + 4 pairs
    assert "config_hash" in json.loads(lines[0])
    assert len(count_calls) == 2
    r2 = _port_processor(seq, ckpt).process_sequence(FRAMES)
    assert len(count_calls) == 2            # nothing dispatched on resume
    np.testing.assert_allclose(np.stack(r1["R"]), np.stack(r2["R"]),
                               atol=1e-12)
    np.testing.assert_array_equal(r1["valid"], r2["valid"])
    for k in ("roll", "pitch", "yaw", "num_matches"):
        np.testing.assert_array_equal(r1[k], r2[k])


def test_checkpoint_rejects_different_config(seq, tmp_path, count_calls):
    ckpt = tmp_path / "ckpt.jsonl"
    _port_processor(seq, ckpt).process_sequence([0, 1, 2])
    n = len(count_calls)
    bp = _port_processor(seq, ckpt)
    bp.seed = 1234                          # part of the config hash
    bp.process_sequence([0, 1, 2])
    assert len(count_calls) > n, "a stale-config checkpoint must recompute"
    assert (tmp_path / "ckpt.jsonl.stale").exists()
    assert json.loads(ckpt.read_text().splitlines()[0])["config_hash"] == \
        bp._config_hash()


def test_checkpoint_ignores_stale_frames(seq, tmp_path, count_calls):
    ckpt = tmp_path / "ckpt.jsonl"
    _port_processor(seq, ckpt).process_sequence([0, 1, 2])
    n = len(count_calls)
    r = _port_processor(seq, ckpt).process_sequence([2, 3, 4])
    assert len(r["frames"]) == 2
    assert len(count_calls) > n             # frame2 mismatch: recomputed


def test_checkpoint_salt_isolates_dataset_slices(seq, tmp_path, count_calls):
    ckpt = tmp_path / "ckpt.jsonl"
    bp1 = _port_processor(seq, ckpt)
    bp1.checkpoint_salt = "images-A|step=1"
    bp1.process_sequence([0, 1, 2])
    n = len(count_calls)
    bp2 = _port_processor(seq, ckpt)
    bp2.checkpoint_salt = "images-B|step=2"
    bp2.process_sequence([0, 1, 2])
    assert len(count_calls) > n, "a different salt must recompute"


# ---- inlier-collapse fallback (tests/test_fallback.py) ----------------------

def test_fallback_adopts_the_references_pairs(seq, capsys):
    """Every pair of the starved config is re-run at orb512 (the threshold
    is out of reach) and the stronger answer is adopted. The reference's
    BatchProcessor adopts, for every pair here, its pairs-batched entry's
    answer at orb512 with the pair's key (its primary cannot hold more than
    64 inliers): the port's adopted pairs equal those in `valid` and match
    counts, R within 0.5 deg."""
    import jax.numpy as jnp

    from rpe_tpu.pipeline.estimator import estimate_pairs_batched

    cfg = dataclasses.replace(WEAK, fallback_profile="orb512",
                              fallback_min_inliers=10 ** 5)
    d, K, _ = seq
    frames = [0, 1, 2]
    paths = [str(d / f"{i:06d}.png") for i in frames]
    _, tp = _processors(seq, cfg=cfg, chunk=2)
    capsys.readouterr()
    Rt, _, vt, nt = tp._estimate_all_pairs(frames, TLazy(paths))
    assert "Fallback: re-running 2 collapsed pair(s) at profile orb512" in \
        capsys.readouterr().out
    fb = tbatch.FALLBACK_BATCH
    sel = [0, 1] + [1] * (fb - 2)           # the padded batch, as both pad
    imgs = JLazy(paths)
    keys = jnp.stack([jax.random.PRNGKey(i) for i in sel])
    ref = estimate_pairs_batched(
        jnp.asarray(imgs[sel]), jnp.asarray(imgs[[i + 1 for i in sel]]),
        jnp.asarray(K), keys, cfg=jcfg.profile_config("orb512"))
    ref = {k: np.asarray(v)[:2] for k, v in ref.items()}
    np.testing.assert_array_equal(vt, ref["valid"])
    assert vt.all()
    np.testing.assert_array_equal(nt, ref["num_matches"])
    assert rotation_error_deg(Rt, ref["R"]).max() < 0.5
    # the adopted answers are the stronger profile's: more matches kept
    _, tb = _processors(seq, cfg=WEAK, chunk=2)
    nb = tb._estimate_all_pairs(frames, TLazy(paths))[3]
    assert (nt > nb).all(), (nt, nb)
    assert (ref["num_inliers"] > 64).all()


def test_unported_options_raise(seq):
    """The options once refused run. A device mesh: process_sequence over
    frames 0-3 under a two-entry CPU mesh at chunk 3 (rounded down to 2,
    so the last of the 3 pairs sits in a padded chunk) equals the run
    without a mesh (`valid` and matches exactly, R within 1e-5) and the
    reference's under a 2-device JAX mesh (the file's contract). VP
    refinement. Fewer than 2 frames still raise."""
    from jax.sharding import Mesh as JMesh

    from rpe_tpu_torch.parallel.mesh import pairs_mesh

    frames = FRAMES[:4]
    jp, tp = _processors(seq)
    base = tp.process_sequence(frames)
    jp.mesh = JMesh(np.array(jax.devices()[:2]), ("pairs",))
    tp.mesh = pairs_mesh(2, device="cpu")
    ref, got = jp.process_sequence(frames), tp.process_sequence(frames)
    assert tp.timer.counts["dispatch"] == 2     # pairs (0, 1), then (2, pad)
    assert tp.meter.n_chips == 2 and tp.meter.pairs == 3
    for want in (base, ref):
        assert got["frames"] == want["frames"] == frames[1:]
        np.testing.assert_array_equal(got["valid"], want["valid"])
        np.testing.assert_array_equal(got["num_matches"],
                                      want["num_matches"])
    assert got["valid"].all()
    np.testing.assert_allclose(np.stack(got["R"]), np.stack(base["R"]),
                               rtol=0, atol=1e-5)
    assert rotation_error_deg(np.stack(got["R"]),
                              np.stack(ref["R"])).max() < 0.5
    d, K, _ = seq
    gt = TGT(d / "camera_poses.txt")
    gt.load()
    # VP refinement is ported (tests/test_torch_vp.py holds it to the
    # reference): process_sequence runs it, one statistics entry a frame
    vp = tbatch.BatchProcessor(
        d, TEstimator(K, use_vp_refinement=True, config=_port_cfg(TINY),
                      nfeatures=TINY.orb.nfeatures,
                      max_matches=TINY.matcher.max_matches, device="cpu"),
        gt, chunk=CHUNK)
    out = vp.process_sequence(FRAMES)
    assert out["frames"] == FRAMES[1:]
    assert len(vp.vp_frames) == len(FRAMES)
    assert vp.vp_used.shape == (len(FRAMES) - 1,)
    assert vp.timer.counts["vp"] == 1
    with pytest.raises(ValueError, match="at least 2 frames"):
        vp.process_sequence([0])


def test_observability_matches_reference(monkeypatch):
    """ThroughputMeter's rates and StageTimer's report as the reference's,
    on the same clock readings; sync is a no-op for CPU tensors."""
    import torch

    from rpe_tpu.utils import observability as jobs
    from rpe_tpu_torch.utils import observability as tobs

    steps = [0.0, 0.5, 0.25, 0.25, 1.0, 0.125, 0.125, 0.5]
    out = []
    for mod in (jobs, tobs):
        ticks = iter(np.cumsum(steps).tolist())
        monkeypatch.setattr(mod.time, "perf_counter",
                            lambda ticks=ticks: next(ticks))
        m = mod.ThroughputMeter(n_chips=2)
        m.start()
        m.lap(pairs=8)
        m.lap(pairs=8)
        m.stop(pairs=16)
        t = mod.StageTimer()
        with t.stage("decode"):
            pass
        with t.stage("decode"):
            pass
        out.append((m.pairs_per_sec_per_chip(),
                    m.steady_pairs_per_sec_per_chip(), m.pairs, t.report()))
    assert out[0] == out[1]
    tobs.sync({"x": [torch.zeros(2)]})             # CPU: returns at once
