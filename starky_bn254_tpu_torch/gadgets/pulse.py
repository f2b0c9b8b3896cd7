"""Pulse columns: one-hot row selectors proved with inverse witnesses.

Re-derivation of reference src/utils/pulse.rs: a global row counter plus, per
pulse position, a pair (witness, pulse) with pulse = 1 iff counter == pos,
proved by `(counter - pos) * witness + pulse == 1` and
`(counter - pos) * pulse == 0` (the witness holds 1/(counter - pos), 0 at the
position). The periodic variant proves an existing column pulses with a given
period/phase via a mod-period counter.
"""

from __future__ import annotations

import functools

import numpy as np

from .. import goldilocks as gl
from ..stark.consumer import ConstraintConsumer
from ..stark.field_expr import RowView
from .limbs import const_lanes


def get_pulse_col(start_pulse_col: int, i: int) -> int:
    return start_pulse_col + 1 + 2 * i + 1


def get_witness_col(start_pulse_col: int, i: int) -> int:
    return start_pulse_col + 1 + 2 * i


@functools.lru_cache(maxsize=8)
def _inv_table(n: int) -> np.ndarray:
    """Inverses of v mod p for v in [-(n-1), n-1]; index = v + n - 1.

    One bulk inversion serves every pulse/periodic witness column (their
    difference values always lie in this window), replacing the reference's
    per-cell inversions (pulse.rs:27-36): host Montgomery batch inversion,
    one pow and 3 multiplies an element in exact ints."""
    p = gl.P
    vals = [p - v for v in range(n - 1, 0, -1)] + list(range(n))
    prefix = []
    acc = 1
    for v in vals:
        prefix.append(acc)
        acc = acc * (v or 1) % p
    inv_acc = pow(acc, p - 2, p)
    out = np.zeros(len(vals), dtype=np.uint64)
    for i in range(len(vals) - 1, -1, -1):
        if vals[i]:
            out[i] = prefix[i] * inv_acc % p
            inv_acc = inv_acc * vals[i] % p
    return out


def generate_pulse(n: int, pulse_positions: list[int]) -> np.ndarray:
    """Returns [n, 1 + 2 * len(positions)] appended columns (counter first)."""
    assert all(0 <= p < n for p in pulse_positions)
    counter = np.arange(n, dtype=np.int64)
    table = _inv_table(n)
    cols = [counter.astype(np.uint64)]
    for p in pulse_positions:
        witness = table[counter - p + n - 1]
        pulse = np.zeros(n, dtype=np.uint64)
        pulse[p] = 1
        cols += [witness, pulse]
    return np.stack(cols, axis=1)


def eval_pulse(
    cc: ConstraintConsumer,
    lv: RowView,
    nv: RowView,
    start_pulse_col: int,
    pulse_positions: list[int],
):
    counter = lv.col(start_pulse_col)
    cc.constraint_first_row(counter)
    cc.constraint_transition(nv.col(start_pulse_col) - counter - 1)
    k = len(pulse_positions)
    wit = lv.cols_idx([get_witness_col(start_pulse_col, i) for i in range(k)])
    pul = lv.cols_idx([get_pulse_col(start_pulse_col, i) for i in range(k)])
    pos = const_lanes(pulse_positions, cc.ext)
    cmp = counter.lane() - pos  # [.., k]
    cc.constraint(cmp * wit + pul - 1)
    cc.constraint(cmp * pul)


def generate_periodic_pulse_witness(
    pulse_col_values: np.ndarray, period: int, first_pulse: int
) -> np.ndarray:
    """Returns [n, 2] appended columns (mod-period counter, inverse witness);
    validates the claimed pulse column on the way (reference pulse.rs:100-144)."""
    n = len(pulse_col_values)
    assert first_pulse < period
    initial = period - first_pulse - 1
    counter = (initial + np.arange(n, dtype=np.int64)) % period
    expect = (counter == period - 1).astype(np.uint64)
    assert np.array_equal(expect, pulse_col_values.astype(np.uint64)), (
        "pulse column inconsistent with claimed period/phase"
    )
    table = _inv_table(period)
    inv = table[counter - (period - 1) + period - 1]
    return np.stack([counter.astype(np.uint64), inv], axis=1)


def eval_periodic_pulse(
    cc: ConstraintConsumer,
    lv: RowView,
    nv: RowView,
    pulse_col: int,
    start_col: int,
    period: int,
    first_pulse: int,
):
    counter = lv.col(start_col)
    witness = lv.col(start_col + 1)
    is_reset = lv.col(pulse_col)
    next_counter = nv.col(start_col)

    initial = period - first_pulse - 1
    cc.constraint_first_row(counter - initial)
    cc.constraint_transition((1 - is_reset) * (next_counter - counter - 1))
    cc.constraint_transition(is_reset * next_counter)
    delta = counter - (period - 1)
    cc.constraint(delta * witness + is_reset - 1)
    cc.constraint(delta * is_reset)
