"""instances_per_s: every instance proven in the stream over the time from
the stream's start to its last proof (the pipeline's one fill included)."""

from readers import proven


def read(record: dict):
    if record.get("loop") != "stream" or not record.get("stamps"):
        return None
    start, end = record["window"]
    return sum(r["instances"] for r in proven(record)) / (end - start)
