"""device_idle_pct: 100 x (1 - the union of device activity intervals
over the wall time of the profiled requests, tracegen included)."""

from readers import idle_pct


def read(record: dict):
    return idle_pct(record) if record.get("loop") == "closed" else None
