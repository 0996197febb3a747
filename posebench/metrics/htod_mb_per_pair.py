"""htod_mb_per_pair: the bytes (in 1e6) of host-made tables that the traced
calls copied to the card, over their pairs. Read from the program's
`htod_bytes` counter (rpe_tpu_torch/utils/observability.py `htod`), which
adds only while a profiler is active, so only the traced calls count; the
counter is reset once read. None where the program has no such counter or
it counted nothing."""


def read(trace):
    try:
        from rpe_tpu_torch.utils import observability as obs
    except ImportError:
        return None
    if not hasattr(obs, "counters") or trace.pairs <= 0:
        return None
    n = obs.counters().get("htod_bytes", 0)
    obs.reset_counters()
    return n / 1e6 / trace.pairs if n else None
