"""tracegen_rangecheck_ms: the program's `tracegen/range check` span (the
range check's columns), mean per profiled request, ms."""

from program_spans import mean_span_ms


def read(record: dict):
    return mean_span_ms(record, "closed", "tracegen/range check")
