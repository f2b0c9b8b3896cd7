# Frozen copy of starky_bn254_tpu_torch/gadgets/pulse.py at commit fb7d4c0,
# cut to what the verifier reaches: no tracegen, aux build, commitment,
# proof-of-work search or proof serialisation.
# Part of the benchmark's reference verifier: never edited to follow the port.
"""Pulse columns: one-hot row selectors proved with inverse witnesses.

Re-derivation of reference src/utils/pulse.rs: a global row counter plus, per
pulse position, a pair (witness, pulse) with pulse = 1 iff counter == pos,
proved by `(counter - pos) * witness + pulse == 1` and
`(counter - pos) * pulse == 0` (the witness holds 1/(counter - pos), 0 at the
position). The periodic variant proves an existing column pulses with a given
period/phase via a mod-period counter.
"""

from __future__ import annotations



from .. import goldilocks as gl
from ..stark.consumer import ConstraintConsumer
from ..stark.field_expr import RowView
from .limbs import const_lanes


def get_pulse_col(start_pulse_col: int, i: int) -> int:
    return start_pulse_col + 1 + 2 * i + 1


def get_witness_col(start_pulse_col: int, i: int) -> int:
    return start_pulse_col + 1 + 2 * i


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
