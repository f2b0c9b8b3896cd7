"""commit_ms: the TimingTree's trace commit, aux commit and quotient
commit (NTTs, leaf hashing, Merkle trees), mean per prove."""

from readers import mean_phase_ms


def read(record: dict):
    return mean_phase_ms(record, ("trace commit", "aux (Z/logup) commit/commit", "quotient commit"))
