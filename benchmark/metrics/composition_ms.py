"""composition_ms: the TimingTree's constraint composition, mean per prove."""

from readers import mean_phase_ms


def read(record: dict):
    return mean_phase_ms(record, ("constraint composition",))
