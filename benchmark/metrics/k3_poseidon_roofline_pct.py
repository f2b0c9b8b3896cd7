"""k3_poseidon_roofline_pct: K3's bound over its device time, both summed
over the profiled proves: every leaf sponge, Merkle level, transcript
digest (work.poseidon_calls) and the grind batches these inputs needed,
counted by the grind kernel's launches in the trace. Poseidon leaves only:
under another leaf hash the count would not hold."""

import work
from readers import K3_GRIND, K3_NAMES, roofline_pct


def _grind_batches(prof) -> int:
    return prof["kernels"].get(K3_GRIND, {}).get("launches", 0)


def _bound_ms(shape, prof):
    return (work.poseidon_bound_ms(shape, 0) * prof["requests"]
            + work.grind_bound_ms(shape, _grind_batches(prof)))


def _launches(shape, prof):
    return len(work.poseidon_calls(shape, 0)) * prof["requests"] + _grind_batches(prof)


def read(record: dict):
    if record["stark"]["merkle_hash"] != "poseidon":
        return None
    return roofline_pct(record, "poseidon", K3_NAMES, _bound_ms, _launches)
