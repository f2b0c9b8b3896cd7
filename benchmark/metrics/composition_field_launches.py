"""composition_field_launches: the field-kernel launches (the program's
goldilocks.LAUNCHES) of the constraint composition, a profiled request:
the `field_launches` counts of the prove's composition row blocks, summed
over a request's blocks, mean over the profiled requests. None where the
program records no such count."""

from program_spans import profiled_spans

PATH = "prove/constraint composition/block"


def read(record: dict):
    if record.get("loop") != "closed" or "profile" not in record:
        return None
    counts = [s.counts["field_launches"] for s in profiled_spans() or []
              if s.path == PATH and "field_launches" in s.counts]
    return sum(counts) / record["profile"]["requests"] if counts else None
