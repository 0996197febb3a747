"""The program's stages in a traced window: each device event charged to
the span of rpe_tpu_torch that launched it.

The program marks its entry's work with four spans, one after another on
the calling thread ("rpe.detect", "rpe.match", "rpe.ransac", "rpe.pose";
pipeline/estimator.py). Under the profiler they arrive as host events
("cpu_op") on the device trace's clock; their shadows on the device's
timeline are dropped by `devtrace`. A device event's correlation id leads
to the runtime call that launched it (only "runtime" events are taken for
launch calls); the span on that call's thread that holds the call's start
is the event's stage. An event whose launch lies in no such span has no
stage (the benchmark's own copies of the outputs to the host, for one).

For each stage `split` gives:
  launches  the device events it launched (work as a count);
  device_s  their durations clipped to the window (time busy);
  idle_s    the idle gaps of the window's device timeline (the union that
            `device_idle_pct` reads) that an event of the stage ended
            (time the card waited on the stage's host path).
The gaps ended by events of no stage and the gap after the last event are
kept apart, so that every stage's idle, those and `after_s` sum to the
window's idle time.
"""

from __future__ import annotations

import bisect

PREFIX = "rpe."
STAGES = ("detect", "match", "ransac", "pose")


def _spans(events):
    """tid -> (starts, [(start, end, stage)]) of the program's stage spans,
    sorted by start."""
    names = {PREFIX + s: s for s in STAGES}
    by_tid: dict[int, list] = {}
    for e in events:
        if e["kind"] == "cpu_op" and e["name"] in names:
            by_tid.setdefault(e["tid"], []).append(
                (e["start"], e["start"] + e["dur"], names[e["name"]]))
    out = {}
    for tid, spans in by_tid.items():
        spans.sort()
        out[tid] = ([s for s, _, _ in spans], spans)
    return out


def split(trace) -> dict | None:
    """The stages' launches, device and idle seconds of a Trace (see the
    module's docstring), with None's entries for events of no stage and
    `after_s`; None where the trace holds no span of the program."""
    cached = trace.__dict__.get("_stage_split", False)
    if cached is not False:
        return cached
    spans = _spans(trace.events)
    runtime = {e["corr"]: e for e in trace.events
               if e["kind"] == "runtime" and e["corr"]}

    def stage_of(dev):
        rt = runtime.get(dev["corr"]) if dev["corr"] else None
        if rt is None or rt["tid"] not in spans:
            return None
        starts, lst = spans[rt["tid"]]
        i = bisect.bisect_right(starts, rt["start"]) - 1
        if i >= 0 and rt["start"] <= lst[i][1]:
            return lst[i][2]
        return None

    out = None
    if spans:
        keys = STAGES + (None,)
        out = {"launches": dict.fromkeys(keys, 0),
               "device_s": dict.fromkeys(keys, 0.0),
               "idle_s": dict.fromkeys(keys, 0.0), "after_s": 0.0}
        end = trace.t0
        for e in trace.device:
            st = stage_of(e)
            out["launches"][st] += 1
            s = max(e["start"], trace.t0)
            t = min(e["start"] + e["dur"], trace.t1)
            if t <= s:
                continue
            out["device_s"][st] += t - s
            if s > end:
                out["idle_s"][st] += s - end
            end = max(end, t)
        out["after_s"] = max(trace.t1 - end, 0.0)
    trace.__dict__["_stage_split"] = out
    return out


def per_pair(trace, stage: str, what: str, scale: float = 1.0):
    """`split(trace)[what][stage]` x `scale` over the traced pairs; None
    without the program's spans, device events or pairs."""
    s = split(trace)
    if s is None or trace.pairs <= 0 or not trace.device:
        return None
    return s[what][stage] * scale / trace.pairs
