"""The per-layer readers and the breakdown on a canned list of profiler
events."""

import pytest

import devtrace
import roofline
from helpers import BENCH


def ev(name, kind, start, dur, corr=0, tid=1):
    return {"name": name, "kind": kind, "start": start, "dur": dur,
            "corr": corr, "tid": tid}


KERNELS = {"fast_harris_kernel": "fast_harris",
           "hamming_tc_kernel": "match_hamming"}


def canned():
    # one call span of 10 s; device busy 1-3 (two overlapping), 5-6, 8-9
    return [
        ev(devtrace.CALL_SPAN, "span", 0.0, 10.0),
        ev("aten::mul", "cpu_op", 0.5, 0.6),
        ev("cudaLaunchKernel", "runtime", 0.9, 0.05, corr=1),
        ev("void fast_harris_kernel<1>(float const*)", "kernel", 1.0, 1.5,
           corr=1),
        ev("at::native::vectorized_elementwise_kernel", "kernel", 2.0, 1.0,
           corr=2),
        ev("aten::sort", "cpu_op", 4.0, 1.0),
        ev("cudaLaunchKernel", "runtime", 4.8, 0.1, corr=3),
        ev("hamming_tc_kernel(int)", "kernel", 5.0, 1.0, corr=3),
        ev("Memcpy DtoH (Device -> Pageable)", "memcpy", 8.0, 1.0, corr=4),
    ]


def trace(counts=None):
    return devtrace.Trace(canned(), calls=1, pairs=4, kernels=KERNELS,
                          counts=counts or {})


def reader(name):
    import manifest

    return manifest.load_module(BENCH / "metrics" / f"{name}.py",
                                "test_" + name)


def test_window_and_busy():
    t = trace()
    assert t.window_s == pytest.approx(10.0)
    assert t.busy_s == pytest.approx(2.0 + 1.0 + 1.0)


def test_device_idle_pct():
    assert reader("device_idle_pct").read(trace()) == pytest.approx(60.0)


def test_launches_per_pair():
    assert reader("launches_per_pair").read(trace()) == pytest.approx(1.0)


def test_kernel_device_pct():
    assert reader("kernel_device_pct").read(trace()) == pytest.approx(
        100.0 * 2.5 / 4.0)


def test_kernel_roofline_pct():
    # K1: 1.5 s on the card, bound by bytes 3.35e12 -> 1 s; K3: 1 s, bound
    # by operations 1979e12 * 0.25 -> 0.25 s
    counts = {"K1": (3.35e12, 0.0, roofline.FP32_OPS_PER_S),
              "K3": (0.0, 0.25 * roofline.INT8_OPS_PER_S,
                     roofline.INT8_OPS_PER_S),
              "P1": (1.0, 1.0, roofline.FP32_OPS_PER_S)}   # did not run
    got = reader("kernel_roofline_pct").read(trace(counts))
    assert got == pytest.approx(100.0 * 1.25 / 2.5)


def test_readers_return_none_without_events():
    empty = devtrace.Trace([ev(devtrace.CALL_SPAN, "span", 0.0, 1.0)],
                           calls=1, pairs=4, kernels=KERNELS, counts={})
    for name in ("device_idle_pct", "launches_per_pair",
                 "kernel_device_pct", "kernel_roofline_pct"):
        assert reader(name).read(empty) is None


def test_breakdown():
    t = trace()
    ops = dict(t.device_ops())
    assert ops["void fast_harris_kernel<1>(float const*)"] == pytest.approx(
        1.5)
    gaps = dict(t.idle_gaps())
    # 0-1 before the first kernel (launched inside aten::mul), 3-5 before
    # K3 (aten::sort), 6-8 before the copy (no runtime call seen), 9-10
    assert gaps["aten::mul/cudaLaunchKernel"] == pytest.approx(1.0)
    assert gaps["aten::sort/cudaLaunchKernel"] == pytest.approx(2.0)
    assert gaps["no host operation"] == pytest.approx(2.0)
    assert gaps["after the last device event"] == pytest.approx(1.0)


def test_kernel_names_from_the_sources():
    names = devtrace.own_kernels(BENCH.parent / "rpe_tpu_torch" / "csrc")
    assert {"fast_harris_kernel", "extract_brief_kernel", "hamming_tc_kernel",
            "finalize_cols32", "finalize_cols", "coeffs_kernel",
            "group_bmm_kernel", "ori_hist_kernel", "desc_kernel"} <= set(names)
    for unit, fns in roofline.UNITS.items():
        assert set(fns) <= set(names), unit
    assert devtrace.kernel_name("void extract_brief_kernel<true, 2>(float "
                                "const*, int)") == "extract_brief_kernel"
    assert devtrace.kernel_name("finalize_cols32(unsigned int const*)") == \
        "finalize_cols32"
    assert devtrace.kernel_name("void (anonymous namespace)::desc_kernel<"
                                "false>(float const*)") == "desc_kernel"
