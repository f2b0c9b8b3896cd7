"""tracegen_chain_ms: the program's `tracegen/chain` span (the native
double-and-add or power chain), mean per profiled request, ms."""

from program_spans import mean_span_ms


def read(record: dict):
    return mean_span_ms(record, "closed", "tracegen/chain")
