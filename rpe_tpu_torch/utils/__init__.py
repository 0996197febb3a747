"""Cross-cutting utilities: observability (timers, throughput, spans and
counters), the finite-value audits, the device policy and synthetic test
data (port of rpe_tpu.utils)."""

from .observability import StageTimer, ThroughputMeter, log, sync

__all__ = ["StageTimer", "ThroughputMeter", "log", "sync"]
