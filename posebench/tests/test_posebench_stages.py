"""The stage readers (posebench/stages.py and its metrics) and the
host-to-device copy counter's reader on canned profiler events."""

import pytest
import torch

import devtrace
import stages
from test_posebench_metrics import KERNELS, ev, reader

STAGE_METRICS = [f"{s}_{w}_per_pair" for w in ("launches", "device_ms",
                                               "idle_ms")
                 for s in stages.STAGES]


def span(stage, start, end, tid=1):
    return ev(stages.PREFIX + stage, "cpu_op", start, end - start, tid=tid)


def canned():
    # one call span of 20 s; the stages' spans one after another on thread
    # 1; device busy 1-4 (two overlapping kernels), 7-7.5, 10.5-12,
    # 15.2-15.4, 18-18.5
    return [
        ev(devtrace.CALL_SPAN, "span", 0.0, 20.0),
        span("detect", 0.5, 6.0), span("match", 6.0, 9.0),
        span("ransac", 9.0, 14.0), span("pose", 14.0, 17.0),
        ev("aten::mul", "cpu_op", 0.7, 0.5, corr=9),
        ev("cudaLaunchKernel", "runtime", 0.8, 0.05, corr=1),
        ev("cudaLaunchKernel", "runtime", 1.0, 0.05, corr=2),
        ev("cudaMemcpyAsync", "runtime", 6.5, 0.05, corr=3),
        ev("cudaLaunchKernel", "runtime", 10.0, 0.05, corr=4),
        ev("cudaLaunchKernel", "runtime", 15.0, 0.05, corr=5),
        # the benchmark's copy of the outputs: launched under no span
        ev("cudaMemcpyAsync", "runtime", 17.5, 0.05, corr=6),
        # a host operation named like a runtime call, inside rpe.pose, with
        # the correlation id of rpe.match's copy: not its launch
        ev("cudaMemcpyAsync", "cpu_op", 14.5, 0.1, corr=3),
        ev("void fast_harris_kernel<1>(float const*)", "kernel", 1.0, 2.0,
           corr=1),
        ev("at::native::vectorized_elementwise_kernel", "kernel", 2.5, 1.5,
           corr=2),
        ev("Memcpy HtoD (Pageable -> Device)", "memcpy", 7.0, 0.5, corr=3),
        ev("hamming_tc_kernel(int)", "kernel", 10.5, 1.5, corr=4),
        ev("at::native::where_kernel", "kernel", 15.2, 0.2, corr=5),
        ev("Memcpy DtoH (Device -> Pageable)", "memcpy", 18.0, 0.5, corr=6),
    ]


def trace(events=None, pairs=4):
    return devtrace.Trace(canned() if events is None else events, calls=1,
                          pairs=pairs, kernels=KERNELS, counts={})


def test_each_stage_launch_device_and_idle():
    s = stages.split(trace())
    assert s["launches"] == {"detect": 2, "match": 1, "ransac": 1, "pose": 1,
                             None: 1}
    want_dev = {"detect": 3.5, "match": 0.5, "ransac": 1.5, "pose": 0.2,
                None: 0.5}
    want_idle = {"detect": 1.0, "match": 3.0, "ransac": 3.0, "pose": 3.2,
                 None: 2.6}
    for k in want_dev:
        assert s["device_s"][k] == pytest.approx(want_dev[k]), k
        assert s["idle_s"][k] == pytest.approx(want_idle[k]), k
    assert s["after_s"] == pytest.approx(1.5)
    got = {m: reader(m).read(trace()) for m in STAGE_METRICS}
    assert got["detect_launches_per_pair"] == pytest.approx(2 / 4)
    assert got["pose_launches_per_pair"] == pytest.approx(1 / 4)
    assert got["detect_device_ms_per_pair"] == pytest.approx(3500 / 4)
    assert got["ransac_device_ms_per_pair"] == pytest.approx(1500 / 4)
    assert got["match_idle_ms_per_pair"] == pytest.approx(3000 / 4)
    assert got["pose_idle_ms_per_pair"] == pytest.approx(3200 / 4)


def test_idle_identity():
    """The stages' idle, the gaps ended by events of no stage and the gap
    after the last event sum to device_idle_pct of the window."""
    for events in (canned(), canned()[:-1], canned()[:-2] + canned()[-1:]):
        t = trace(events)
        s = stages.split(t)
        idle = sum(s["idle_s"].values()) + s["after_s"]
        pct = reader("device_idle_pct").read(t)
        assert abs(idle - pct / 100 * t.window_s) < 1e-9
        assert abs(idle - (t.window_s - t.busy_s)) < 1e-9
        assert sum(s["launches"].values()) == len(t.device)


def test_a_launch_under_no_span_counts_for_no_stage():
    events = canned()
    # kernel 5's launch moved past rpe.pose's end, and to another thread
    for tid, start in ((1, 17.2), (2, 15.0)):
        moved = [dict(e, start=start, tid=tid)
                 if e["kind"] == "runtime" and e["corr"] == 5 else e
                 for e in events]
        s = stages.split(trace(moved))
        assert s["launches"]["pose"] == 0
        assert s["launches"][None] == 2
        assert s["idle_s"][None] == pytest.approx(2.6 + 3.2)
        assert reader("pose_launches_per_pair").read(trace(moved)) == 0.0


def test_a_host_event_named_like_a_runtime_call_is_not_a_launch():
    # without the runtime call, rpe.match's copy has no launch at all,
    # though a host operation named cudaMemcpyAsync carries its id
    events = [e for e in canned()
              if not (e["kind"] == "runtime" and e["corr"] == 3)]
    s = stages.split(trace(events))
    assert s["launches"]["match"] == 0
    assert s["launches"]["pose"] == 1
    assert s["launches"][None] == 2


def test_stage_readers_say_nothing_without_the_programs_spans():
    events = [e for e in canned() if not e["name"].startswith(stages.PREFIX)]
    # the spans but no device event: a run on the CPU
    host = [e for e in canned() if e["kind"] not in devtrace.DEVICE_KINDS]
    for m in STAGE_METRICS:
        assert reader(m).read(trace(events)) is None
        assert reader(m).read(trace(pairs=0)) is None
        assert reader(m).read(trace(host)) is None


def test_htod_reader_reads_the_counter_once():
    from rpe_tpu_torch.utils import observability as obs

    obs.reset_counters()
    r = reader("htod_mb_per_pair")
    assert r.read(trace()) is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        obs.count("htod_bytes", 6_000_000)
    assert r.read(trace()) == pytest.approx(6.0 / 4)
    assert obs.counters() == {}
    assert r.read(trace()) is None
