"""tracegen_check_ms: the program's `tracegen/oracle check` span (each
instance's output against the exact-int oracle), mean per profiled
request, ms."""

from program_spans import mean_span_ms


def read(record: dict):
    return mean_span_ms(record, "closed", "tracegen/oracle check")
