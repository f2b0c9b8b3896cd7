"""worker_tracegen_ms.service: the program's `pipeline/worker tracegen`
span (the forked worker's tracegen, from the stamps it sends with the
trace), mean per batch of the profiled stream, ms."""

from program_spans import mean_span_ms


def read(record: dict):
    return mean_span_ms(record, "stream", "pipeline/worker tracegen")
