"""Batched Fq multiplication AIR — the minimum end-to-end BN254 statement.

Equivalent of the reference's in-module `ModularStark` test STARK
(src/modular/modular.rs:361-537): each row proves
`input0 * input1 == output (mod p_BN254)` under a filter column, with the
split-u16 range check over output + aux columns.

Row layout (reference modular.rs:408-423):
  [ input0(16) | input1(16) | output(16) | out_aux_red(16) | quot_abs(17)
  | aux_lo(31) | aux_hi(31) | quot_sign(1) | filter(1) ]     = 145 main cols
  + [ table(1) | 6 per checked col (112..) ]                  range check
"""

from __future__ import annotations

import numpy as np

from .. import bn254
from ..gadgets import modular as mod
from ..gadgets import range_check as rc
from ..gadgets.limbs import pol_mul_wide
from ..stark.air import Air
from ..utils.conversions import N_LIMBS, int_to_limbs

MAIN_COLS = 9 * N_LIMBS + 1  # 145
START_RANGE_CHECK = 2 * N_LIMBS  # skip the two input operands
NUM_RANGE_CHECK = 7 * N_LIMBS - 1  # output + aux cells
RANGE_TARGETS = list(range(START_RANGE_CHECK, START_RANGE_CHECK + NUM_RANGE_CHECK))


class FqMulAir(Air):
    num_public_inputs = 0
    num_columns = MAIN_COLS + 1 + 6 * NUM_RANGE_CHECK

    def __init__(self, num_rows: int):
        self.num_rows = num_rows

    def permutation_pairs(self):
        return rc.split_u16_range_check_pairs(MAIN_COLS, NUM_RANGE_CHECK)

    # -- witness -------------------------------------------------------------
    def generate_trace(self, inputs: list[tuple[int, int]]) -> np.ndarray:
        """inputs: list of (x, y) Fq pairs; pads with filter=0 rows."""
        n = self.num_rows
        assert len(inputs) <= n
        rows = np.zeros((n, MAIN_COLS), dtype=np.uint64)
        for r, (x, y) in enumerate(inputs):
            pol_input = [0] * (2 * N_LIMBS - 1)
            xl = int_to_limbs(x, N_LIMBS)
            yl = int_to_limbs(y, N_LIMBS)
            for i in range(N_LIMBS):
                for j in range(N_LIMBS):
                    pol_input[i + j] += xl[i] * yl[j]
            w = mod.generate_modular_op(bn254.P_BN, pol_input)
            assert w["output_int"] == x * y % bn254.P_BN
            row = (
                xl
                + yl
                + w["output"]
                + w["out_aux_red"]
                + w["quot_abs"]
                + w["aux_lo"]
                + w["aux_hi"]
                + [w["quot_sign"], 1]
            )
            rows[r] = np.array(row, dtype=np.uint64)
        # filtered-off padding rows keep quot_sign = 1 (reference
        # fq/mul.rs:24-32 FqOutput::default)
        for r in range(len(inputs), n):
            rows[r, MAIN_COLS - 2] = 1
        rc_cols = rc.generate_split_u16_range_check(rows, RANGE_TARGETS)
        return np.concatenate([rows, rc_cols], axis=1)

    # -- constraints ----------------------------------------------------------
    def eval(self, lv, nv, pi, cc):
        c = 0
        input0 = lv.cols(c, c + N_LIMBS); c += N_LIMBS
        input1 = lv.cols(c, c + N_LIMBS); c += N_LIMBS
        output = lv.cols(c, c + N_LIMBS); c += N_LIMBS
        out_aux_red = lv.cols(c, c + N_LIMBS); c += N_LIMBS
        quot_abs = lv.cols(c, c + N_LIMBS + 1); c += N_LIMBS + 1
        aux_lo = lv.cols(c, c + 2 * N_LIMBS - 1); c += 2 * N_LIMBS - 1
        aux_hi = lv.cols(c, c + 2 * N_LIMBS - 1); c += 2 * N_LIMBS - 1
        quot_sign = lv.col(c); c += 1
        filter_v = lv.col(c); c += 1
        assert c == MAIN_COLS

        rc.eval_split_u16_range_check(cc, lv, nv, MAIN_COLS, RANGE_TARGETS)
        input_pol = pol_mul_wide(input0, input1)
        mod.eval_modular_op(
            cc,
            filter_v,
            bn254.P_BN,
            input_pol,
            output,
            quot_sign,
            out_aux_red,
            quot_abs,
            aux_lo,
            aux_hi,
        )
