"""openings_ms: the TimingTree's openings and opening combine, mean per prove."""

from readers import mean_phase_ms


def read(record: dict):
    return mean_phase_ms(record, ("openings", "opening combine"))
