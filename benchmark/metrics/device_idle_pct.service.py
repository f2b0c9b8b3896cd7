"""device_idle_pct.service: 100 x (1 - the union of device activity
intervals over the wall time of a profiled stream, its fill included)."""

from readers import idle_pct


def read(record: dict):
    return idle_pct(record) if record.get("loop") == "stream" else None
