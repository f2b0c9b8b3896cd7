"""Exponent-bit flag state machine for 256-bit double-and-add schedules.

Re-derivation of reference src/utils/flags.rs: the exponent is held as 8 u32
limbs; each pair of rows consumes one bit (split on `a` rows), and every 64
rows (phase 62) the limb window rotates down, so one 256-bit exponent costs
2*32*8 = 512 rows. Column block (NUM_FLAGS_COLS = 14, offsets relative to
start_flags_col):

  0: is_final   1: is_rotate   2: a   3: b   4: filtered_bit (= b * bit)
  5: bit        6..13: limbs[8]

`a` rows (odd) halve limb0 and extract the next bit; `b` rows are where the
conditional multiply fires (filtered_bit). Witness generation is vectorized
across instances (numpy), 512-step loop.
"""

from __future__ import annotations

import numpy as np

from ..stark.consumer import ConstraintConsumer
from ..stark.field_expr import RowView
from ..utils.conversions import INPUT_LIMB_BITS, NUM_INPUT_LIMBS

NUM_FLAGS_COLS = 6 + NUM_INPUT_LIMBS
NUM_FLAG_ROWS = 2 * INPUT_LIMB_BITS * NUM_INPUT_LIMBS  # 512


def generate_flag_columns(exp_limbs: np.ndarray) -> np.ndarray:
    """exp_limbs: [num_io, 8] u32. Returns [num_io, 512, 14] u64 flag cells
    for every instance block at once."""
    num_io = exp_limbs.shape[0]
    rows = np.zeros((num_io, NUM_FLAG_ROWS, NUM_FLAGS_COLS), dtype=np.uint64)

    limbs = exp_limbs.astype(np.uint64).copy()
    # row 0: a=0, b=1, bit = limb0 & 1, limb0 >>= 1
    bit = limbs[:, 0] & 1
    limbs[:, 0] >>= 1
    rows[:, 0, 3] = 1  # b
    rows[:, 0, 4] = bit  # filtered_bit = bit * b
    rows[:, 0, 5] = bit

    rows[:, 0, 6:] = limbs
    for i in range(NUM_FLAG_ROWS - 1):
        r = i + 1
        a_cur = i & 1  # a flag of row i
        rows[:, r, 2] = 1 - a_cur
        rows[:, r, 3] = a_cur
        if i == NUM_FLAG_ROWS - 2:
            rows[:, r, 0] = 1  # is_final on the last row
        if i % (2 * INPUT_LIMB_BITS) == 2 * INPUT_LIMB_BITS - 3:
            rows[:, r, 1] = 1  # is_rotate
        was_rotate = rows[:, i, 1] == 1
        if a_cur == 1:
            # split row: consume one bit from limb0
            bit = limbs[:, 0] & 1
            limbs[:, 0] >>= 1
        if was_rotate.any():
            # rotate rows have a=0, so split and rotate never collide
            limbs[was_rotate] = np.roll(limbs[was_rotate], -1, axis=1)
            limbs[was_rotate, -1] = 0
        rows[:, r, 5] = bit
        rows[:, r, 4] = bit * rows[:, r, 3]
        rows[:, r, 6:] = limbs
    return rows


def eval_flags(
    cc: ConstraintConsumer, lv: RowView, nv: RowView, start_flag_col: int
):
    """Constraint set from reference flags.rs:136-195 (the spec)."""
    s = start_flag_col
    is_final = lv.col(s)
    is_rotate = lv.col(s + 1)
    a = lv.col(s + 2)
    b = lv.col(s + 3)
    filtered_bit = lv.col(s + 4)
    bit = lv.col(s + 5)
    limb0 = lv.col(s + 6)
    n_a = nv.col(s + 2)
    n_b = nv.col(s + 3)
    n_bit = nv.col(s + 5)
    n_limb0 = nv.col(s + 6)

    # initial conditions
    cc.constraint_first_row(a)
    cc.constraint_first_row(b - 1)
    # row-local
    cc.constraint(bit * bit - bit)
    cc.constraint(bit * b - filtered_bit)
    cc.constraint(is_rotate * a)
    cc.constraint(is_final * is_rotate)
    # alternation
    cc.constraint_transition(a + n_a - 1)
    cc.constraint_transition(b + n_b - 1)
    # split rows: limb0 = 2*limb0' + bit'
    not_final = 1 - is_final
    cc.constraint_transition(not_final * a * (limb0 - n_limb0 * 2 - n_bit))
    # non-split rows: bit and limb0 carry over
    not_split = 1 - a
    not_rot_fin = 1 - is_rotate - is_final
    cc.constraint_transition(not_split * (n_bit - bit))
    cc.constraint_transition(not_rot_fin * not_split * (limb0 - n_limb0))
    # rotate / non-rotate limb window (lane-stacked over limbs 1..7)
    hi_limbs = lv.cols(s + 7, s + 6 + NUM_INPUT_LIMBS)  # limbs[1..8)
    hi_limbs_next_down = nv.cols(s + 6, s + 5 + NUM_INPUT_LIMBS)  # limbs'[0..7)
    hi_limbs_next = nv.cols(s + 7, s + 6 + NUM_INPUT_LIMBS)
    cc.constraint_transition(is_rotate.lane() * (hi_limbs_next_down - hi_limbs))
    cc.constraint_transition(is_rotate * nv.col(s + 6 + NUM_INPUT_LIMBS - 1))
    cc.constraint_transition(not_rot_fin.lane() * (hi_limbs_next - hi_limbs))
