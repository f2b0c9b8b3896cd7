"""fri_ms: the TimingTree's fri (folds and layer trees, final polynomial,
proof-of-work grind, query extraction), mean per prove."""

from readers import mean_phase_ms


def read(record: dict):
    return mean_phase_ms(record, ("fri",))
