"""What the metric readers under metrics/ share: the window's proofs, the
mean of a prove phase, the device's idle share, a hand kernel's share of
its roofline. Every reader returns None where its record holds nothing to
read, and the metric is then left out of the line."""

from __future__ import annotations

import statistics
import sys

import work
from devtrace import HAND_KERNELS

K1_NAMES = HAND_KERNELS["ntt"]
K3_NAMES = HAND_KERNELS["poseidon"]
K3_GRIND = "poseidon_grind_kernel"


def proven(record: dict) -> list[dict]:
    return [r for r in record.get("requests", []) if r["proof"] is not None]


def mean_phase_ms(record: dict, names: tuple[str, ...]) -> float | None:
    """The mean over the window's traced proves of the summed TimingTree
    scopes `names` (an absent scope counts 0; None when no prove was
    timed)."""
    timed = [r["phases"] for r in proven(record) if "phases" in r]
    if not timed:
        return None
    return statistics.fmean(sum(p.get(n, 0.0) for n in names) for p in timed)


def idle_pct(record: dict) -> float | None:
    prof = record.get("profile")
    if not prof or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])


def peak_gib(record: dict) -> float | None:
    b = record.get("peak_window_bytes")
    return None if b is None else b / 2**30


def prove_shape(record: dict) -> work.ProveShape | None:
    reqs = proven(record)
    if not reqs:
        return None
    s, st = reqs[0]["shape"], record["stark"]
    return work.ProveShape(rows=s["rows"], trace_cols=s["trace_cols"], aux_cols=s["aux_cols"],
                           public_inputs=s["public_inputs"], num_challenges=st["num_challenges"],
                           rate_bits=st["rate_bits"], cap_height=st["cap_height"],
                           final_poly_bits=st["final_poly_bits"], pow_bits=st["pow_bits"])


def kernel_seconds(prof: dict, names: tuple[str, ...]) -> tuple[int, float]:
    ks = prof["kernels"]
    return (sum(ks.get(n, {}).get("launches", 0) for n in names),
            sum(ks.get(n, {}).get("seconds", 0.0) for n in names))


def roofline_pct(record: dict, wrapper: str, names: tuple[str, ...], bound_ms,
                 modelled_launches) -> float | None:
    """100 x the summed bound of the profiled proves' launches over their
    device time. None without a profile or launches, where the profiler
    dropped launches of this kernel (its time would be short), or where the
    trace holds another number of launches than work.py's model of a prove
    (the bound would count work the program no longer launches, or miss
    work it does): that mismatch is printed."""
    prof = record.get("profile")
    shape = prove_shape(record)
    if not prof or shape is None or wrapper in prof.get("dropped", {}):
        return None
    launches, seconds = kernel_seconds(prof, names)
    if launches == 0 or seconds <= 0:
        return None
    expected = modelled_launches(shape, prof)
    if launches != expected:
        print(f"readers: the trace holds {launches} {wrapper} launches where work.py counts "
              f"{expected} for {prof['requests']} proves; {wrapper}'s roofline is left out",
              file=sys.stderr)
        return None
    return 100.0 * bound_ms(shape, prof) / (seconds * 1e3)
