# Frozen copy of starky_bn254_tpu_torch/gadgets/flags.py at commit fb7d4c0,
# cut to what the verifier reaches: no tracegen, aux build, commitment,
# proof-of-work search or proof serialisation.
# Part of the benchmark's reference verifier: never edited to follow the port.
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


from ..stark.consumer import ConstraintConsumer
from ..stark.field_expr import RowView
from ..utils.conversions import INPUT_LIMB_BITS, NUM_INPUT_LIMBS

NUM_FLAGS_COLS = 6 + NUM_INPUT_LIMBS
NUM_FLAG_ROWS = 2 * INPUT_LIMB_BITS * NUM_INPUT_LIMBS  # 512


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
