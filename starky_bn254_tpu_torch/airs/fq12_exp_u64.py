"""Fq12 exponentiation with a u64 exponent: 128 rows per instance.

Equivalent of reference `Fq12ExpU64Stark` (src/fields/fq12_u64/exp_u64.rs):
same multiply gadget as Fq12ExpAir but driven by the 6-column u64 flag
machine (no limb rotation, no periodic pulse). The MSM-style chaining test
(circuit.rs:437-489) composes these blocks to prove products of powers
(compose/msm.py::prove_fq12_multiexp with u64=True).

Row layout: [ a(192) | b(192) | Fq12Output(1344) | flags_u64(6) ] = 1734
main cols + io-pulses(1+4*num_io) or final-periodic(2) + range check (same
targets as Fq12ExpAir). Public IO per instance: 36*N_LIMBS + 1 (exp_val is
one cell).

The port of the JAX package's airs/fq12_exp_u64.py. The JAX package builds
the trace row by row with a batched numpy witness (gadgets/fq12_batch.py);
the port runs the native "fq12_exp_chain" over the u64 flags instead (the
squaring rows are flag col 1, the multiply rows flag col 3), which writes
the same cells. `generate_trace_and_pi(..., exact=True)` runs the exact-int
Fq12 gadget, the tests' reference.

The exponent cell of the public inputs is `e % 2^64` as a raw u64 word, as
in the JAX package: an exponent at or above p = 2^64 - 2^32 + 1 gives a
non-canonical field value there.
"""

from __future__ import annotations

import numpy as np

from ..gadgets import flags_u64 as fl64
from ..stark.field_expr import lane_concat
from ..utils.conversions import N_LIMBS
from .fq12_exp import START_FLAGS, Fq12ExpBase

NUM_MAIN = 108 * N_LIMBS + fl64.NUM_FLAGS_U64_COLS  # 1734
FQ12_EXP_U64_IO_LEN = 36 * N_LIMBS + 1  # 577
ROWS_PER_BLOCK = fl64.NUM_FLAG_U64_ROWS  # 128


class Fq12ExpU64Air(Fq12ExpBase):
    """num_io independent `offset * x^exp` instances over Fq12, 128 rows
    each; exp is taken mod 2^64."""

    NUM_MAIN = NUM_MAIN
    IO_LEN = FQ12_EXP_U64_IO_LEN
    ROWS_PER_BLOCK = ROWS_PER_BLOCK
    EXP_CELLS = 1  # one u64 word
    PERIODIC_COLS = 0
    SQ_FLAG, MUL_FLAG = 1, 3  # flag cols `a` and `filtered_bit`

    def _flag_rows(self, inputs):
        exps = np.array([self._exponent(e) for (_, _, e) in inputs], dtype=np.uint64)
        return fl64.generate_flag_u64_columns(exps)  # [io, 128, 6]

    def _exponent(self, e):
        return e % (1 << 64)

    def _exp_public_cells(self, e):
        return [self._exponent(e)]  # a raw u64 word, possibly >= p

    def _rlc_input_cells(self, view):
        restored = self._exp_row_cells(view, view.col(START_FLAGS + self.MUL_FLAG))
        return lane_concat([view.cols(0, 24 * N_LIMBS), restored.lane()])

    def _exp_row_cells(self, view, is_mul):
        """The exponent, restored from val and the first filtered bit."""
        return view.col(START_FLAGS + 5) * 2 + is_mul

    def _host_exp_cells(self, flags):
        return [int(flags[5]) * 2 + int(flags[self.MUL_FLAG])]

    def _eval_exp_io(self, cc, is_in, pi, off, restored):
        cc.constraint(is_in * (pi.col(off) - restored))

    def _eval_flags(self, cc, lv, nv):
        fl64.eval_flags_u64(cc, lv, nv, START_FLAGS)
