"""Timing, throughput, spans and counters (port of
rpe_tpu/utils/observability.py).

  * `span(name)`: a profiler range while a torch profiler is active
    (`profiling()`), and nothing but that check otherwise. A span adds no
    sync and reads no tensor; under a profile it is a host event on the
    device trace's clock, inside whatever span encloses it on its thread.
    It is a function-scope range (`_range`), recorded as an operator's
    is: `torch.profiler.record_function`'s user annotation also casts a
    range over the work it launched onto the device's timeline, where a
    reader of the trace can take it for device work.
  * `count(name, n)`: an in-memory counter that adds only while a profiler
    is active; `counters()` reads them, `reset_counters()` clears them.
    Nothing is written out.
  * `htod(a, device)`: a table made on the host as a tensor on `device`,
    its bytes counted under `HTOD` ("htod_bytes").
  * `StageTimer`: wall-clock per pipeline stage; each stage is also a
    `span`.
  * `ThroughputMeter`: pairs/sec/chip.
  * `log`: [LEVEL]-prefixed printing.

`sync` is `torch.cuda.synchronize()` on the device of the first tensor it
finds, and a no-op for CPU tensors.
"""

from __future__ import annotations

import contextlib
import json
import time

import torch

# True while a torch profiler (torch.profiler.profile or the autograd
# profiler) records on this process
profiling = torch._C._autograd._profiler_enabled

HTOD = "htod_bytes"

# a function-scope profiler range, no user annotation (see the docstring)
_range = torch._C._profiler._RecordFunctionFast

_OFF = contextlib.nullcontext()
_COUNTS: dict[str, int] = {}


def span(name: str):
    """A context manager: a profiler range named `name` while a profiler
    is active, else a shared no-op."""
    if profiling():
        return _range(name)
    return _OFF


def count(name: str, n: int) -> None:
    """Add `n` to the counter `name` while a profiler is active."""
    if profiling():
        _COUNTS[name] = _COUNTS.get(name, 0) + int(n)


def counters() -> dict[str, int]:
    """The counters added since the last `reset_counters()`."""
    return dict(_COUNTS)


def reset_counters() -> None:
    _COUNTS.clear()


def htod(a, device, dtype=None) -> torch.Tensor:
    """`a` (a numpy array, a CPU tensor or a list), made `dtype` on the
    host when given, as a tensor on `device`: one copy, whose host bytes
    `count` adds under HTOD. The device tensor is not read."""
    t = torch.as_tensor(a, dtype=dtype)
    count(HTOD, t.nbytes)
    return t.to(device)


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
    def stage(self, name: str):
        t0 = time.perf_counter()
        with span(name):
            yield
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

    def lap(self, pairs: int):
        """Record one dispatch of `pairs` pairs since start()/last lap()."""
        t = time.perf_counter()
        self.laps.append((pairs, t - self._t0))
        self._t0 = t

    def stop(self, pairs: int):
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
