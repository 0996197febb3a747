"""Timing, throughput and tracing (port of rpe_tpu/utils/observability.py).

  * `StageTimer`: wall-clock per pipeline stage; each stage is also a
    `torch.profiler.record_function` range, so a trace shows it beside the
    device's work.
  * `ThroughputMeter`: pairs/sec/chip.
  * `trace`: a `torch.profiler` context over the CPU and, with a card, CUDA.
  * `log`: [LEVEL]-prefixed printing.

`sync` is `torch.cuda.synchronize()` on the device of the first tensor it
finds, and a no-op for CPU tensors.
"""

from __future__ import annotations

import contextlib
import json
import time

import torch


def _first_tensor(x):
    if isinstance(x, torch.Tensor):
        return x
    items = x.values() if isinstance(x, dict) else (
        x if isinstance(x, (list, tuple)) else ())
    for v in items:
        t = _first_tensor(v)
        if t is not None:
            return t
    return None


def sync(x) -> None:
    """Wait for the device that holds `x` (a tensor, or a dict, list or
    tuple holding one) to finish its queued work."""
    t = _first_tensor(x)
    if t is not None and t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def log(level: str, msg: str, **fields) -> None:
    """[INFO]/[DEBUG]/[WARN] prefixed line, + optional JSON fields."""
    suffix = f" {json.dumps(fields)}" if fields else ""
    print(f"[{level.upper()}] {msg}{suffix}")


class StageTimer:
    """Accumulates per-stage wall-clock times."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        with torch.profiler.record_function(name):
            yield
            if sync_on is not None:
                sync(sync_on)
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> dict:
        return {
            name: {"total_s": round(t, 4),
                   "count": self.counts[name],
                   "mean_ms": round(1000 * t / self.counts[name], 3)}
            for name, t in self.totals.items()
        }

    def print_report(self):
        for name, row in self.report().items():
            log("info", f"stage {name}: {row['mean_ms']} ms x "
                        f"{row['count']} = {row['total_s']} s")


class ThroughputMeter:
    """pairs/sec/chip counter.

    Two readings: the total rate (the first dispatch included, which pays
    for building and loading the kernels) and the steady-state rate (laps
    after the first). Record each dispatch with `lap()`.
    """

    def __init__(self, n_chips: int = 1):
        self.n_chips = n_chips
        self.pairs = 0
        self.elapsed = 0.0
        self.laps: list[tuple[int, float]] = []  # (pairs, seconds)
        self._t0 = None

    def start(self):
        self._t0 = time.perf_counter()

    def lap(self, pairs: int, sync_on=None):
        """Record one dispatch of `pairs` pairs since start()/last lap()."""
        if sync_on is not None:
            sync(sync_on)
        t = time.perf_counter()
        self.laps.append((pairs, t - self._t0))
        self._t0 = t

    def stop(self, pairs: int, sync_on=None):
        if sync_on is not None:
            sync(sync_on)
        self.elapsed += time.perf_counter() - self._t0
        self.pairs += pairs
        if self.laps:
            # start()/lap() usage: laps carry the truth; fold them in.
            self.pairs = sum(p for p, _ in self.laps)
            self.elapsed = sum(t for _, t in self.laps)

    def pairs_per_sec_per_chip(self) -> float:
        if self.elapsed <= 0:
            return 0.0
        return self.pairs / self.elapsed / self.n_chips

    def steady_pairs_per_sec_per_chip(self) -> float:
        """Rate excluding the first lap (build + warmup). 0.0 if <2 laps."""
        if len(self.laps) < 2:
            return 0.0
        p = sum(l[0] for l in self.laps[1:])
        t = sum(l[1] for l in self.laps[1:])
        if t <= 0:
            return 0.0
        return p / t / self.n_chips


@contextlib.contextmanager
def trace(logdir: str):
    """A torch.profiler trace of the block, written under `logdir` as a
    Chrome trace (view in Perfetto or TensorBoard); yields the profiler,
    whose `key_averages()` sum the device time by kernel."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(logdir))) as prof:
        yield prof
