"""rpe_tpu_torch's spans and counters (utils/observability.py) on the CPU:
nothing recorded or counted without a profiler, the estimator's four stage
spans and its host-to-device table bytes under one, the private profiler
check they rest on, and the copy sites that must count."""

import ast
import importlib
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rpe_tpu_torch import rng
from rpe_tpu_torch.config import EstimatorConfig
from rpe_tpu_torch.ops import atlas as tatlas
from rpe_tpu_torch.ops import orb as torb
from rpe_tpu_torch.ops.pyramid import level_shapes
from rpe_tpu_torch.pipeline import estimator as est
from rpe_tpu_torch.utils import observability as obs
from rpe_tpu_torch.utils.synthetic import make_sequence
from torch_gates import default_extraction_gates  # noqa: F401

# the module (the package's `recover_pose` is its function)
trp = importlib.import_module("rpe_tpu_torch.geometry.recover_pose")
ROOT = Path(__file__).resolve().parents[1]
H, W = 120, 160
STAGES = ["rpe.detect", "rpe.match", "rpe.ransac", "rpe.pose"]


@pytest.fixture(scope="module")
def chunk():
    frames, K, _ = make_sequence(3, H, W, seed=0)
    keys = np.stack([np.asarray(rng.PRNGKey(i)) for i in range(2)])
    return frames, K, keys.astype(np.uint32)


@pytest.fixture(autouse=True)
def fresh_counters():
    obs.reset_counters()
    yield
    obs.reset_counters()


def _call(chunk):
    frames, K, keys = chunk
    return est.estimate_sequence_batched(frames, K, keys, device="cpu")


@pytest.fixture
def no_range(monkeypatch):
    """The spans' profiler range replaced by one that fails the test."""
    def fail(name):
        raise AssertionError(f"span {name!r} entered with no profiler")

    monkeypatch.setattr(obs, "_range", fail)


@pytest.mark.parametrize("what", ["unit", "estimator"])
def test_no_profiler_records_and_counts_nothing(chunk, no_range, what):
    assert not obs.profiling()
    if what == "unit":
        with obs.span("rpe.detect"):
            obs.count(obs.HTOD, 7)
        timer = obs.StageTimer()
        with timer.stage("dispatch"):
            pass
        assert timer.counts == {"dispatch": 1}
        assert obs.htod(np.ones(3, np.float32), "cpu").tolist() == [1, 1, 1]
    else:
        out = _call(chunk)
        assert out["valid"].shape == (2,)
    assert obs.counters() == {}


def test_profiler_check_follows_the_profiler():
    """`profiling` is torch's private check of an active profiler: a
    PyTorch that moves or breaks it fails here, not by turning the spans
    and counters off unseen."""
    assert obs.profiling is torch._C._autograd._profiler_enabled
    assert obs.profiling() is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert obs.profiling() is True
    assert obs.profiling() is False
    with torch.autograd.profiler.profile():
        assert obs.profiling() is True
    assert obs.profiling() is False


def test_a_span_is_a_host_range_without_a_device_shadow():
    """A span is recorded as an operator is, not as a user annotation,
    whose range the profiler would also lay on the device's timeline."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("rpe.detect"):
            torch.ones(3).add_(1)
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "rpe.detect"]
    assert len(ev) == 1
    assert not ev[0].is_user_annotation()
    assert str(ev[0].device_type()).endswith("CPU")


def test_estimator_spans_and_table_bytes_under_the_profiler(chunk,
                                                            monkeypatch):
    decomposed = []
    real = trp.decompose_essential
    monkeypatch.setattr(trp, "decompose_essential",
                        lambda E: decomposed.append(1) or real(E))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = _call(chunk)
    assert out["valid"].shape == (2,)
    spans = sorted((e.start_ns(), e.end_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("rpe."))
    assert [n for _, _, n in spans] == STAGES
    for (_, end, _), (start, _, _) in zip(spans, spans[1:]):
        assert end <= start

    o = EstimatorConfig().orb
    Rv, Cws = tatlas._atlas_resize_mats(H, W, o.nlevels, o.scale_factor)
    offsets, total, wp = tatlas.atlas_layout(H, W, o.nlevels,
                                             o.scale_factor)
    mask = torb._atlas_valid_mask(
        tuple(offsets), total, wp,
        tuple(level_shapes(H, W, o.nlevels, o.scale_factor)),
        torb.EDGE_MARGIN)
    # the card's path: the atlas's resize matrices and valid mask, t (0, 0,
    # 1) and one W (float32) per decomposition of E (recoverPose, and the
    # ambiguity blend's)
    card = (Rv.nbytes + sum(c.nbytes for c in Cws) + mask.nbytes + 3 * 4
            + 9 * 4 * len(decomposed))
    # K2's plain version on the CPU takes its tables from ops/orb.py (the IC
    # masks, the BRIEF pattern); K2 on the card holds them once per device
    plain = (sum(a.nbytes for a in torb._ic_angle_masks())
             + torb.brief_pattern().astype(np.float32).nbytes)
    assert len(decomposed) >= 1
    assert obs.counters() == {obs.HTOD: card + plain}


def _from_numpy_to(tree):
    """Calls `torch.from_numpy(...).to(...)` in a module's syntax tree."""
    return [n for n in ast.walk(tree)
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "to" and isinstance(n.func.value, ast.Call)
            and ast.unparse(n.func.value.func) == "torch.from_numpy"]


def _htod_calls(tree):
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and isinstance(n.func, ast.Name) and n.func.id == "htod"]


@pytest.mark.parametrize("module,sites", [("atlas.py", 2), ("orb.py", 5)])
def test_every_table_copy_counts_its_bytes(module, sites):
    """ORB's host-made tables reach the call's device only through
    `observability.htod`, which counts them: no `torch.from_numpy(...).to(`
    is left, and each copy site (the atlas's Rv and Cws, the valid mask,
    the IC masks, the BRIEF pattern and steering tables) calls `htod`."""
    tree = ast.parse((ROOT / "rpe_tpu_torch" / "ops" / module).read_text())
    assert _from_numpy_to(tree) == []
    assert len(_htod_calls(tree)) == sites
    # and the helper counts the host bytes it copies
    with profile(activities=[ProfilerActivity.CPU]):
        obs.htod(np.zeros((5, 3), np.uint8), "cpu")
        obs.htod([0.0, 0.0, 1.0], "cpu", torch.float32)
    assert obs.counters() == {obs.HTOD: 15 + 12}
