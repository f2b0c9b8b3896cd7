"""tracegen_ms: the benchmark's span around generate_trace_and_pi, mean
per proof over the traced window."""

import statistics

from readers import proven


def read(record: dict):
    timed = [r["tracegen_s"] for r in proven(record) if "phases" in r]
    return statistics.fmean(timed) * 1e3 if timed else None
