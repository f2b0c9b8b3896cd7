"""aux_ms: the TimingTree's aux column build (logUp and RLC columns), mean per prove."""

from readers import mean_phase_ms


def read(record: dict):
    return mean_phase_ms(record, ("aux (Z/logup) commit/column build",))
