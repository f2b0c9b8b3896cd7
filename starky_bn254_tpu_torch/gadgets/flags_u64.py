"""Simplified exponent-bit flags for 64-bit exponents (no limb rotation).

Re-derivation of reference src/fields/fq12_u64/flags_u64.rs: 6 columns
[is_final, a, b, filtered_bit, bit, val]; one bit consumed per row pair;
2*64 = 128 rows per instance. `a` (col 1) has the same pattern in every
instance (0 on row 0, then alternating 1, 0, ...): the rows that square.
"""

from __future__ import annotations

import numpy as np

from ..stark.consumer import ConstraintConsumer
from ..stark.field_expr import RowView

NUM_FLAGS_U64_COLS = 6
NUM_FLAG_U64_ROWS = 2 * 64  # 128


def generate_flag_u64_columns(exp_vals: np.ndarray) -> np.ndarray:
    """exp_vals: [num_io] u64. Returns [num_io, 128, 6] flag cells."""
    io = exp_vals.shape[0]
    rows = np.zeros((io, NUM_FLAG_U64_ROWS, NUM_FLAGS_U64_COLS), dtype=np.uint64)
    val = exp_vals.astype(np.uint64).copy()
    bit = val & 1
    val >>= 1
    rows[:, 0, 2] = 1  # b
    rows[:, 0, 3] = bit
    rows[:, 0, 4] = bit
    rows[:, 0, 5] = val
    for i in range(NUM_FLAG_U64_ROWS - 1):
        r = i + 1
        a_cur = i & 1
        rows[:, r, 1] = 1 - a_cur
        rows[:, r, 2] = a_cur
        if i == NUM_FLAG_U64_ROWS - 2:
            rows[:, r, 0] = 1
        if a_cur == 1:
            bit = val & 1
            val >>= 1
        rows[:, r, 4] = bit
        rows[:, r, 3] = bit * rows[:, r, 2]
        rows[:, r, 5] = val
    return rows


def eval_flags_u64(cc: ConstraintConsumer, lv: RowView, nv: RowView, s: int):
    is_final = lv.col(s)
    a = lv.col(s + 1)
    b = lv.col(s + 2)
    filtered_bit = lv.col(s + 3)
    bit = lv.col(s + 4)
    val = lv.col(s + 5)
    n_a = nv.col(s + 1)
    n_b = nv.col(s + 2)
    n_bit = nv.col(s + 4)
    n_val = nv.col(s + 5)

    cc.constraint_first_row(a)
    cc.constraint_first_row(b - 1)
    cc.constraint(bit * bit - bit)
    cc.constraint(bit * b - filtered_bit)
    cc.constraint_transition(a + n_a - 1)
    cc.constraint_transition(b + n_b - 1)
    not_final = 1 - is_final
    cc.constraint_transition(not_final * a * (val - n_val * 2 - n_bit))
    not_split = 1 - a
    cc.constraint_transition(not_split * (n_bit - bit))
    cc.constraint_transition(not_final * not_split * (val - n_val))
