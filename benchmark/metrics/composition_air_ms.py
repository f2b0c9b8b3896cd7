"""composition_air_ms: the AIR's own constraints in the constraint
composition, ms a profiled request: the program's `air` spans (its
`air.eval`) under the prove's composition row blocks, summed over a
request's blocks, mean over the profiled requests. The rest of a block is
the permutation, logUp and IO-binding constraints (`arguments`) and its
division by Z_H. None where the program records no such span."""

from program_spans import profiled_spans

PATH = "prove/constraint composition/block/air"


def read(record: dict):
    if record.get("loop") != "closed" or "profile" not in record:
        return None
    ms = [(s.end_ns - s.start_ns) / 1e6 for s in profiled_spans() or [] if s.path == PATH]
    return sum(ms) / record["profile"]["requests"] if ms else None
