"""prefetch_wait_ms.service: the program's `pipeline/wait` span (the
dispatch thread waiting for the next staged trace), mean per batch of the
profiled stream, batch 0 (the fill) left out, ms."""

from program_spans import mean_span_ms


def read(record: dict):
    return mean_span_ms(record, "stream", "pipeline/wait", skip_requests=(0,))
