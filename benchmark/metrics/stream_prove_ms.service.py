"""stream_prove_ms.service: the program's `pipeline/prove` span (one
batch's prove on the dispatch thread), mean per batch of the profiled
stream, ms."""

from program_spans import mean_span_ms


def read(record: dict):
    return mean_span_ms(record, "stream", "pipeline/prove")
