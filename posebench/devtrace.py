"""The traced sub-window: torch.profiler over whole estimator calls inside
the measured window, reduced to a short list of plain events that the
per-layer readers (posebench/metrics/*.py) and the breakdown read.

An event is a dict: name, kind ("kernel", "memcpy", "memset" on the device;
"runtime" for a CUDA runtime call, "cpu_op" for an operator on the host;
"span" for the benchmark's own `posebench.call` span around each call),
start and dur in seconds, corr (the CUDA correlation id that ties a device
event to the runtime call that launched it) and tid. No Chrome trace is
written: the kineto results are read once and dropped.
"""

from __future__ import annotations

import re
from pathlib import Path

CALL_SPAN = "posebench.call"
DEVICE_KINDS = ("kernel", "memcpy", "memset")


def _kind(ev) -> str | None:
    dev = str(ev.device_type())
    act = str(getattr(ev, "activity_type", lambda: "")()).lower()
    if not dev.endswith("CPU"):
        if "annotation" in act or ev.name() == CALL_SPAN:
            return None          # a span's shadow on the device's timeline
        for k in DEVICE_KINDS:
            if k in act:
                return k
        name = ev.name().lower()
        if "memcpy" in name:
            return "memcpy"
        if "memset" in name:
            return "memset"
        return "kernel"
    if ev.name() == CALL_SPAN:
        return "span"
    if "runtime" in act or ev.name().startswith(("cuda", "cu")):
        return "runtime"
    return "cpu_op"


def events_from_profile(prof) -> list[dict]:
    """The profiler's kineto events as plain dicts (seconds)."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        kind = _kind(ev)
        if kind is None:
            continue
        out.append({"name": ev.name(), "kind": kind,
                    "start": ev.start_ns() * 1e-9,
                    "dur": ev.duration_ns() * 1e-9,
                    "corr": int(ev.correlation_id()),
                    "tid": int(ev.start_thread_id())})
    return out


def kernel_name(name: str) -> str:
    """The function name of a demangled kernel name: 'void k<1>(float*)'
    and 'void (anonymous namespace)::k<1>(float*)' -> 'k'."""
    s = name.replace("(anonymous namespace)::", "").strip()
    if s.startswith("void "):
        s = s[5:]
    return re.split(r"[<(]", s, maxsplit=1)[0].strip().split("::")[-1]


def own_kernels(csrc: Path) -> dict[str, str]:
    """Every `__global__` function of the program's CUDA sources -> its
    file's stem (the names come from the program, not from a list here)."""
    pat = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\([^)]*\)"
                     r"\s*)?(?:void\s+)?([A-Za-z_]\w*)\s*\(")
    out = {}
    for src in sorted(csrc.glob("*.cu*")):
        for name in pat.findall(src.read_text()):
            out[name] = src.stem
    return out


class Trace:
    """What one traced sub-window gives the readers."""

    def __init__(self, events, calls: int, pairs: int, kernels: dict,
                 counts: dict):
        self.events = events
        self.calls = calls            # whole estimator calls profiled
        self.pairs = pairs            # pairs those calls returned
        self.kernels = kernels        # own kernel function -> source stem
        self.counts = counts          # roofline unit -> its bound's counts
        spans = [e for e in events if e["kind"] == "span"]
        if spans:
            self.t0 = min(e["start"] for e in spans)
            self.t1 = max(e["start"] + e["dur"] for e in spans)
        else:
            self.t0 = min(e["start"] for e in events)
            self.t1 = max(e["start"] + e["dur"] for e in events)
        dev = [e for e in events if e["kind"] in DEVICE_KINDS
               and e["start"] < self.t1 and e["start"] + e["dur"] > self.t0]
        self.device = sorted(dev, key=lambda e: e["start"])

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def busy_intervals(self):
        """The union of the device events' intervals, clipped to the
        window: a sorted list of (start, end)."""
        out = []
        for e in self.device:
            s = max(e["start"], self.t0)
            t = min(e["start"] + e["dur"], self.t1)
            if t <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], t))
            else:
                out.append((s, t))
        return out

    @property
    def busy_s(self) -> float:
        return sum(t - s for s, t in self.busy_intervals())

    def own_time(self) -> dict[str, float]:
        """Device seconds per own kernel function."""
        out: dict[str, float] = {}
        for e in self.device:
            if e["kind"] != "kernel":
                continue
            k = kernel_name(e["name"])
            if k in self.kernels:
                out[k] = out.get(k, 0.0) + e["dur"]
        return out

    def device_ops(self, n: int = 10):
        """The device operations that took most time: [[name, s], ...]."""
        tot: dict[str, float] = {}
        for e in self.device:
            key = e["name"][:64]
            tot[key] = tot.get(key, 0.0) + e["dur"]
        return [[k, v] for k, v in sorted(tot.items(),
                                         key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """The device's idle gaps inside the window, summed by what the host
        was doing when the gap ended: the operator around the runtime call
        that launched the next device event ("<op>/<runtime call>")."""
        runtime = {e["corr"]: e for e in self.events
                   if e["kind"] == "runtime" and e["corr"]}
        ops = sorted((e for e in self.events if e["kind"] == "cpu_op"),
                     key=lambda e: e["start"])
        starts = [e["start"] for e in ops]

        def host_op(rt):
            import bisect

            i = bisect.bisect_right(starts, rt["start"])
            best = None
            for e in reversed(ops[max(0, i - 64):i]):
                if (e["tid"] == rt["tid"]
                        and e["start"] + e["dur"] >= rt["start"]):
                    if best is None or e["dur"] < best["dur"]:
                        best = e
            return best["name"] if best else "no host operation"

        tot: dict[str, float] = {}
        end = self.t0
        for e in self.device:
            if e["start"] > end:
                rt = runtime.get(e["corr"])
                key = (f"{host_op(rt)}/{rt['name']}" if rt
                       else "no host operation")
                tot[key] = tot.get(key, 0.0) + (e["start"] - end)
            end = max(end, e["start"] + e["dur"])
        if self.t1 > end:
            tot["after the last device event"] = (
                tot.get("after the last device event", 0.0) + self.t1 - end)
        return [[k, v] for k, v in sorted(tot.items(),
                                         key=lambda kv: -kv[1])[:n]]
