# Frozen copy of starky_bn254_tpu_torch/stark/io_rlc.py at commit fb7d4c0,
# cut to what the verifier reaches: no tracegen, aux build, commitment,
# proof-of-work search or proof serialisation.
# Part of the benchmark's reference verifier: never edited to follow the port.
"""Generic challenge-weighted IO binding for block-structured exp AIRs.

Replaces the reference's per-instance one-hot IO pulses (1 + 4*num_io
columns, reference src/utils/pulse.rs usage in every exp STARK) with O(1)
columns: per challenge gamma, two committed aux columns

    W = gamma^{L*k} on the rows of block k          (L = io cells/instance)
    A = running sum of block-boundary increments

with constraints (all degree <= 3):
    first row:  W = 1, A = 0, RLC(inputs of block 0) = RLC(pi block 0 inputs)
    transition: W' = W * (1 + (gamma^L - 1) * is_final)
                A' = A + is_final * W * (RLC_out(x) + gamma^L * RLC_in(gx))
    last row:   RLC_out(x) = RLC(pi last-instance outputs)
                A = full-PI RLC - first-inputs RLC - last-outputs RLC

Soundness: Schwartz-Zippel over gamma (amplified across num_challenges
copies); the is_final flag is separately pinned as a periodic pulse by the
AIR. Cell positions use weight gamma^{pos+1} with pos the cell's index in
the instance's public-input block, so the expected values are plain RLCs of
the public input vector.

The constraints (`eval_extra`) run on the verifier's numpy scalars; the
prover's aux build is not part of this copy.

An AIR plugs in cell accessors:
    input_cells(view)  -> Val lane-stack of the in-trace input cells, in PI
                          order (positions 0 .. in_len-1)
    output_cells(view) -> Val lane-stack of output cells (positions
                          in_len .. io_len-1)
"""

from __future__ import annotations

import numpy as np

from .. import goldilocks as gl
from .field_expr import Val, stack_vals


class RlcIoBinding:
    def __init__(
        self,
        io_len: int,
        in_len: int,
        rows_per_block: int,
        input_cells,
        output_cells,
    ):
        self.io_len = io_len
        self.in_len = in_len
        self.rows_per_block = rows_per_block
        self.input_cells = input_cells
        self.output_cells = output_cells

    @property
    def aux_width(self) -> int:
        return 2

    # ----------------------------------------------------------- constraints
    def eval_extra(
        self, lv, nv, aux_lv, aux_nv, gammas, pi, cc, aux_offset, is_final, num_io
    ):
        L = self.io_len
        for ci, gamma in enumerate(gammas):
            w = aux_lv.col(aux_offset + 2 * ci)
            a_acc = aux_lv.col(aux_offset + 2 * ci + 1)
            w_next = aux_nv.col(aux_offset + 2 * ci)
            a_next = aux_nv.col(aux_offset + 2 * ci + 1)

            gpow = [gamma]
            for _ in range(L - 1):
                gpow.append(gpow[-1] * gamma)
            gL = gpow[L - 1]

            def rlc(cells, base_exp: int):
                k = cells.arr.shape[-2 if cells.ext else -1]
                weights = stack_vals([gpow[base_exp + j] for j in range(k)])
                prod = cells * weights
                axis = -2 if cells.ext else -1
                return Val(gl.sum_mod(prod.arr, axis=axis), cells.ext)

            cc.constraint_first_row(w - 1)
            cc.constraint_first_row(a_acc)
            cc.constraint_transition(w_next - w * (1 + is_final * (gL - 1)))

            out_rlc = rlc(self.output_cells(lv), self.in_len)
            in_rlc = rlc(self.input_cells(nv), 0)
            cc.constraint_transition(
                a_next - a_acc - is_final * w * (out_rlc + gL * in_rlc)
            )

            # expected values from the public inputs, vectorized
            pi_all = pi.cols(0, L * num_io)
            if pi_all.ext:
                mat = pi_all.arr.reshape(num_io, L, 2)
                w_l = stack_vals(gpow).arr  # [L, 2]
                blk = gl.sum_mod(gl.ext_mul(mat, w_l[None, :, :]), axis=1)
                wks = gl.ext_powers_vec(gL.arr, num_io)
                expected_full = Val(gl.sum_mod(gl.ext_mul(blk, wks), axis=0), True)
            else:
                mat = pi_all.arr.reshape(num_io, L)
                w_l = stack_vals(gpow).arr  # [L]
                blk = gl.sum_mod(gl.mul(mat, w_l[None, :]), axis=1)
                wks = gl.powers_vec(gL.arr, num_io)
                expected_full = Val(gl.sum_mod(gl.mul(blk, wks), axis=0), False)

            in0 = rlc(pi.cols(0, self.in_len), 0)
            out_last_pi = rlc(
                pi.cols(L * (num_io - 1) + self.in_len, L * num_io), self.in_len
            )
            if num_io > 1:
                out_last_scaled = Val(wks[num_io - 1], pi_all.ext) * out_last_pi
            else:
                out_last_scaled = out_last_pi
            partial = expected_full - in0 - out_last_scaled

            cc.constraint_first_row(rlc(self.input_cells(lv), 0) - in0)
            cc.constraint_last_row(out_rlc - out_last_pi)
            cc.constraint_last_row(a_acc - partial)
