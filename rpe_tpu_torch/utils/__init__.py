"""Cross-cutting utilities: observability (timers, throughput, tracing),
the finite-value audits, the device policy and synthetic test data (port
of rpe_tpu.utils)."""

from .observability import StageTimer, ThroughputMeter, log, sync, trace

__all__ = ["StageTimer", "ThroughputMeter", "log", "sync", "trace"]
