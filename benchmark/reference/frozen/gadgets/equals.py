# Frozen copy of starky_bn254_tpu_torch/gadgets/equals.py at commit fb7d4c0.
# Part of the benchmark's reference verifier: never edited to follow the port.
"""Filtered equality gadgets (reference src/utils/equals.rs).

All are one-liners on lane-stacked Vals; kept as named helpers so AIR code
reads like the layout documentation.
"""

from __future__ import annotations

from ..stark.consumer import ConstraintConsumer
from ..stark.field_expr import Val


def eval_bool(cc: ConstraintConsumer, v: Val):
    cc.constraint(v * v - v)


def vec_equal(cc: ConstraintConsumer, filter_v: Val, a: Val, b: Val):
    """filter * (a - b) == 0 on every row, lane-stacked."""
    cc.constraint(filter_v.lane() * (a - b))


def vec_equal_transition(cc: ConstraintConsumer, filter_v: Val, a: Val, b: Val):
    cc.constraint_transition(filter_v.lane() * (a - b))


def vec_equal_first(cc: ConstraintConsumer, filter_v: Val, a: Val, b: Val):
    cc.constraint_first_row(filter_v.lane() * (a - b))


def vec_equal_last(cc: ConstraintConsumer, filter_v: Val, a: Val, b: Val):
    cc.constraint_last_row(filter_v.lane() * (a - b))


# fq-specific aliases (16-limb vectors), matching the reference naming
fq_equal_transition = vec_equal_transition
fq_equal_first = vec_equal_first
fq_equal_last = vec_equal_last
