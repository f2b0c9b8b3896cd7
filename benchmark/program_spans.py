"""What the readers of the program's own spans share. While a traced run
records the device trace (devtrace.profile), the port keeps the spans of
the profiled work, its tracegen, prove and pipeline stages, in
`starky_bn254_tpu_torch.utils.timing.DEVICE_TRACE`: each with its path
("tracegen/chain", "pipeline/wait"), its request (a stream's batch index)
and its start and end on time.time_ns(). A program without that recorder
gives None, and the metric is left out of the line."""

from __future__ import annotations

import statistics


def profiled_spans() -> list | None:
    """The program's spans of the profiled work; None where it keeps none."""
    try:
        from starky_bn254_tpu_torch.utils import timing
    except ImportError:
        return None
    rec = getattr(timing, "DEVICE_TRACE", None)
    return None if rec is None else list(rec.spans)


def mean_span_ms(record: dict, loop: str, path: str, skip_requests=()) -> float | None:
    """The mean ms of the profiled spans at `path`, those of the requests in
    `skip_requests` left out, in a profiled record of `loop`; None where
    there are none."""
    if record.get("loop") != loop or "profile" not in record:
        return None
    ms = [(s.end_ns - s.start_ns) / 1e6 for s in profiled_spans() or []
          if s.path == path and s.request not in skip_requests]
    return statistics.fmean(ms) if ms else None
