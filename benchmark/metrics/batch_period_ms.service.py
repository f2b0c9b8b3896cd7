"""batch_period_ms.service: the median gap between consecutive proofs of
the window's stream (on_proof completions), ms."""

import statistics


def read(record: dict):
    stamps = record.get("stamps") or []
    if len(stamps) < 2:
        return None
    return statistics.median(b - a for a, b in zip(stamps, stamps[1:])) * 1e3
