"""Fq exponentiation AIR: proves output = offset * x^exp for batched inputs.

Equivalent of the reference `FqExpStark` (src/fields/fq/exp.rs). Each of the
`num_io` instances occupies a 512-row block driven by the exponent-bit flag
machine: squares fire on `a` rows (is_sq = flag col 2), conditional
multiplies on bit rows (is_mul = filtered_bit, flag col 4); public IO is
pinned at block-boundary pulses (or bound by the RLC accumulator) as 8x
u32 limbs per value.

Row layout (reference exp.rs:1-34):
  [ a(16) | b(16) | FqOutput(112) | flags(14) ]            158 main cols
  + periodic-pulse(2) + io-pulses(1 + 4*num_io) or final-periodic(2)
  + range check over cols 0..142.

FqOutput block: output(16) out_aux_red(16) quot_abs(17) aux_lo(31)
aux_hi(31) quot_sign(1)  (reference fq/mul.rs:49-54).

The port of the JAX package's airs/fq_exp.py. Trace generation runs the
whole square-and-multiply chain in one native call (native.exp_chain);
`generate_trace_and_pi(..., exact=True)` runs the exact-int modular
gadget instead, as the reference the tests hold the native chain against.
"""

from __future__ import annotations

import numpy as np

from .. import bn254, native
from ..gadgets import flags as fl
from ..gadgets import modular as mod
from ..gadgets import pulse as pu
from ..gadgets import range_check as rc
from ..gadgets.equals import vec_equal, vec_equal_transition
from ..gadgets.limbs import pol_mul_wide, u16_to_u32_lanes
from ..stark.air import Air
from ..stark.field_expr import lane_concat
from ..stark.io_rlc import RlcIoBinding
from ..utils.conversions import N_LIMBS, fq_to_u32_limbs, int_to_limbs, limbs_to_int
from .g1_exp import _head, _tail

FQ_OUTPUT_COLS = 7 * N_LIMBS  # 112
NUM_MAIN = 9 * N_LIMBS + fl.NUM_FLAGS_COLS  # 158
START_FLAGS = 9 * N_LIMBS  # 144
NUM_RANGE_CHECK = 9 * N_LIMBS - 1  # 143: everything except quot_sign
RANGE_TARGETS = list(range(NUM_RANGE_CHECK))
FQ_EXP_IO_LEN = 4 * fl.NUM_INPUT_LIMBS  # 32 public cells per instance
ROWS_PER_BLOCK = fl.NUM_FLAG_ROWS  # 512


class FqExpAir(Air):
    """num_io independent `offset * x^exp` instances, 512 rows each."""

    def __init__(
        self, num_io: int, range_check: str = "auto", io_binding: str = "auto"
    ):
        self.num_io = num_io
        if range_check == "auto":
            range_check = "logup_u16" if num_io >= 128 else "logup"
        assert range_check in ("u16", "split", "logup", "logup_u16")
        self.range_check = range_check
        if io_binding == "auto":
            io_binding = "rlc" if num_io >= 128 else "pulse"
        assert io_binding in ("pulse", "rlc")
        self.io_binding = io_binding

        self.start_periodic = NUM_MAIN
        if io_binding == "pulse":
            self.start_io_pulses = NUM_MAIN + 2
            self.start_lookups = self.start_io_pulses + 1 + 4 * num_io
        else:
            self.start_final_periodic = NUM_MAIN + 2
            self.start_lookups = NUM_MAIN + 4
        self.rc_spec = rc.RangeCheckSpec(range_check, self.start_lookups, RANGE_TARGETS)
        self.num_columns = self.start_lookups + self.rc_spec.num_added
        self.num_public_inputs = FQ_EXP_IO_LEN * num_io

    def aux_extra_width(self) -> int:
        return 2 if self.io_binding == "rlc" else 0

    # -------------------------------------------------------- rlc IO binding
    def _rlc_binding(self) -> RlcIoBinding:
        return RlcIoBinding(
            io_len=FQ_EXP_IO_LEN,
            in_len=24,
            rows_per_block=ROWS_PER_BLOCK,
            input_cells=self._input_cells,
            output_cells=self._output_cells,
            host_in_cells=self._host_in_cells,
            host_out_cells=self._host_out_cells,
        )

    def _input_cells(self, view):
        """24 input cells (x, offset u32 lanes; exp limbs with the first bit
        restored) read from a block-start row."""
        s = START_FLAGS
        a32 = u16_to_u32_lanes(view.cols(0, N_LIMBS))
        b32 = u16_to_u32_lanes(view.cols(N_LIMBS, 2 * N_LIMBS))
        limbs = view.cols(s + 6, s + 6 + fl.NUM_INPUT_LIMBS)
        restored0 = _head(limbs) * 2 + view.col(s + 4).lane()
        return lane_concat([a32, b32, restored0, _tail(limbs)])

    def _output_cells(self, view):
        return u16_to_u32_lanes(view.cols(N_LIMBS, 2 * N_LIMBS))

    @staticmethod
    def _u32_cells(trace, row, cols):
        cells = []
        for k in cols:
            limbs = trace[row, k * N_LIMBS : (k + 1) * N_LIMBS]
            for t in range(8):
                cells.append(int(limbs[2 * t]) + (int(limbs[2 * t + 1]) << 16))
        return cells

    def _host_in_cells(self, trace, row):
        s = START_FLAGS
        cells = self._u32_cells(trace, row, (0, 1))
        limbs = [int(v) for v in trace[row, s + 6 : s + 6 + fl.NUM_INPUT_LIMBS]]
        cells.append(limbs[0] * 2 + int(trace[row, s + 4]))
        cells += limbs[1:]
        return cells

    def _host_out_cells(self, trace, row):
        return self._u32_cells(trace, row, (1,))

    def generate_aux(self, trace, gammas):
        return self._rlc_binding().generate_aux(trace, gammas, self.num_io)

    def eval_extra(self, lv, nv, aux_lv, aux_nv, gammas, pi, cc, aux_offset):
        self._rlc_binding().eval_extra(
            lv, nv, aux_lv, aux_nv, gammas, pi, cc, aux_offset,
            is_final=lv.col(START_FLAGS), num_io=self.num_io,
        )

    # ------------------------------------------------------------------ trace
    def pulse_positions(self) -> list[int]:
        pos = []
        for i in range(self.num_io):
            pos += [i * ROWS_PER_BLOCK, i * ROWS_PER_BLOCK + ROWS_PER_BLOCK - 1]
        return pos

    def generate_trace_and_pi(
        self, inputs: list[tuple[int, int, int]], exact: bool = False
    ) -> tuple[np.ndarray, np.ndarray]:
        """inputs: per instance (x, offset, exp_val) as Python ints. exact:
        run the exact-int modular gadget row by row instead of the native
        chain (a test reference, slow).

        Returns (trace [512*num_io, num_columns], public_inputs)."""
        assert len(inputs) == self.num_io
        io = self.num_io
        n = ROWS_PER_BLOCK * io

        exp_limbs = np.array(
            [fq_to_u32_limbs(e % (1 << 256)) for (_, _, e) in inputs],
            dtype=np.uint64,
        )
        flag_rows = fl.generate_flag_columns(exp_limbs)  # [io, 512, 14]

        # one buffer for the whole trace; every section is written in place
        trace_full = np.zeros((n, self.num_columns), dtype=np.uint64)
        m3 = trace_full.reshape(io, ROWS_PER_BLOCK, self.num_columns)
        main = m3[:, :, :NUM_MAIN]  # strided view over the main section
        main[:, :, START_FLAGS:] = flag_rows

        if exact:
            b_int = self._exact_chain(inputs, flag_rows, main)
        else:
            al = np.array([int_to_limbs(x) for (x, _, _) in inputs], dtype=np.uint64)
            bl = np.array([int_to_limbs(o) for (_, o, _) in inputs], dtype=np.uint64)
            fb = native.exp_chain(
                "fq_exp_chain", al, bl,
                is_square=flag_rows[0, :, 2], bits=flag_rows[:, :, 4],
                main=m3, coord_off=0, cells_off=2 * N_LIMBS,
            )
            b_int = [limbs_to_int(fb[i]) for i in range(io)]

        # oracle check (reference exp.rs:240-245)
        for i, (x, off, e) in enumerate(inputs):
            expected = off * pow(x, e, bn254.P_BN) % bn254.P_BN
            assert b_int[i] == expected, "trace generation mismatch vs oracle"

        trace = trace_full[:, :NUM_MAIN]
        trace_full[:, NUM_MAIN : NUM_MAIN + 2] = pu.generate_periodic_pulse_witness(
            trace[:, START_FLAGS + 1], 2 * fl.INPUT_LIMB_BITS, 2 * fl.INPUT_LIMB_BITS - 2
        )
        if self.io_binding == "pulse":
            trace_full[:, self.start_io_pulses : self.start_lookups] = (
                pu.generate_pulse(n, self.pulse_positions())
            )
        else:
            trace_full[:, self.start_final_periodic : self.start_lookups] = (
                pu.generate_periodic_pulse_witness(
                    trace[:, START_FLAGS], ROWS_PER_BLOCK, ROWS_PER_BLOCK - 1
                )
            )
        trace_full[:, self.start_lookups :] = self.rc_spec.generate(
            trace_full[:, : self.start_lookups]
        )

        pi = []
        for i, (x, off, e) in enumerate(inputs):
            pi += fq_to_u32_limbs(x)
            pi += fq_to_u32_limbs(off)
            pi += fq_to_u32_limbs(e % (1 << 256))
            pi += fq_to_u32_limbs(b_int[i])
        return trace_full, np.array(pi, dtype=np.uint64)

    @staticmethod
    def _exact_chain(inputs, flag_rows, main) -> list[int]:
        """The square-and-multiply chain with the exact-int modular gadget,
        one row and one instance at a time; writes main[i, r, :144].
        Returns the final accumulators."""
        a_int = [x for (x, _, _) in inputs]
        b_int = [off for (_, off, _) in inputs]
        c = 2 * N_LIMBS
        for r in range(ROWS_PER_BLOCK):
            for i in range(len(inputs)):
                a, b = a_int[i], b_int[i]
                main[i, r, 0:N_LIMBS] = int_to_limbs(a)
                main[i, r, N_LIMBS:c] = int_to_limbs(b)
                is_sq = flag_rows[i, r, 2] == 1
                is_mul = flag_rows[i, r, 4] == 1
                if is_sq or is_mul:
                    w = _gen_fq_mul(a, a if is_sq else b)
                else:
                    w = mod.zero_modular_aux()
                cells = (w["output"] + w["out_aux_red"] + w["quot_abs"] + w["aux_lo"]
                         + w["aux_hi"] + [w["quot_sign"]])
                main[i, r, c : c + FQ_OUTPUT_COLS] = np.array(cells, dtype=np.uint64)
                if is_sq:
                    a_int[i] = w["output_int"]
                elif is_mul:
                    b_int[i] = w["output_int"]
        return b_int

    def permutation_pairs(self):
        return self.rc_spec.pairs()

    def lookup_tables(self):
        return self.rc_spec.tables()

    # ------------------------------------------------------------ constraints
    def eval(self, lv, nv, pi, cc):
        io = self.num_io
        s = START_FLAGS
        a = lv.cols(0, N_LIMBS)
        b = lv.cols(N_LIMBS, 2 * N_LIMBS)
        c = 2 * N_LIMBS
        output = lv.cols(c, c + N_LIMBS); c += N_LIMBS
        out_aux_red = lv.cols(c, c + N_LIMBS); c += N_LIMBS
        quot_abs = lv.cols(c, c + N_LIMBS + 1); c += N_LIMBS + 1
        aux_lo = lv.cols(c, c + 2 * N_LIMBS - 1); c += 2 * N_LIMBS - 1
        aux_hi = lv.cols(c, c + 2 * N_LIMBS - 1); c += 2 * N_LIMBS - 1
        quot_sign = lv.col(c); c += 1
        assert c == START_FLAGS

        is_final = lv.col(s)
        is_sq = lv.col(s + 2)
        is_mul = lv.col(s + 4)
        not_final = 1 - is_final

        if self.io_binding == "rlc":
            # is_final pinned as a periodic pulse; PI bound via eval_extra
            pu.eval_periodic_pulse(
                cc, lv, nv, START_FLAGS, self.start_final_periodic,
                ROWS_PER_BLOCK, ROWS_PER_BLOCK - 1,
            )
        else:
            # is_final is exactly the sum of the per-instance output pulses
            sum_out = None
            for i in range(io):
                v = lv.col(pu.get_pulse_col(self.start_io_pulses, 2 * i + 1))
                sum_out = v if sum_out is None else sum_out + v
            cc.constraint(is_final - sum_out)

            # public IO pinned at block boundaries
            a32 = u16_to_u32_lanes(a)
            b32 = u16_to_u32_lanes(b)
            limbs = lv.cols(s + 6, s + 6 + fl.NUM_INPUT_LIMBS)
            # exp limbs with the consumed first bit restored: limb0*2 + bit
            restored0 = _head(limbs) * 2 + is_mul.lane()
            rest = _tail(limbs)
            for i in range(io):
                off = FQ_EXP_IO_LEN * i
                x_pi = pi.cols(off, off + 8)
                offset_pi = pi.cols(off + 8, off + 16)
                exp_pi = pi.cols(off + 16, off + 24)
                outp_pi = pi.cols(off + 24, off + 32)
                is_in = lv.col(pu.get_pulse_col(self.start_io_pulses, 2 * i))
                is_out = lv.col(pu.get_pulse_col(self.start_io_pulses, 2 * i + 1))
                vec_equal(cc, is_in, x_pi, a32)
                vec_equal(cc, is_in, offset_pi, b32)
                vec_equal(cc, is_out, outp_pi, b32)
                vec_equal(cc, is_in, _head(exp_pi), restored0)
                vec_equal(cc, is_in, _tail(exp_pi), rest)

        # state transition (reference exp.rs:341-360)
        next_a = nv.cols(0, N_LIMBS)
        next_b = nv.cols(N_LIMBS, 2 * N_LIMBS)
        vec_equal_transition(cc, not_final * is_sq, next_a, output)
        vec_equal_transition(cc, not_final * is_sq, next_b, b)
        vec_equal_transition(cc, not_final * is_mul, next_a, a)
        vec_equal_transition(cc, not_final * is_mul, next_b, output)
        neither = 1 - is_sq - is_mul
        vec_equal_transition(cc, not_final * neither, next_a, a)
        vec_equal_transition(cc, not_final * neither, next_b, b)

        fl.eval_flags(cc, lv, nv, START_FLAGS)

        # the shared multiply gadget under both filters
        for filt, y in ((is_sq, a), (is_mul, b)):
            mod.eval_modular_op(
                cc, filt, bn254.P_BN, pol_mul_wide(a, y), output, quot_sign,
                out_aux_red, quot_abs, aux_lo, aux_hi,
            )

        pu.eval_periodic_pulse(
            cc, lv, nv, START_FLAGS + 1, self.start_periodic,
            2 * fl.INPUT_LIMB_BITS, 2 * fl.INPUT_LIMB_BITS - 2,
        )
        if self.io_binding == "pulse":
            pu.eval_pulse(cc, lv, nv, self.start_io_pulses, self.pulse_positions())
        self.rc_spec.eval(cc, lv, nv)


def _gen_fq_mul(x: int, y: int) -> dict:
    pol_input = [0] * (2 * N_LIMBS - 1)
    xl = int_to_limbs(x, N_LIMBS)
    yl = int_to_limbs(y, N_LIMBS)
    for i in range(N_LIMBS):
        for j in range(N_LIMBS):
            pol_input[i + j] += xl[i] * yl[j]
    return mod.generate_modular_op(bn254.P_BN, pol_input)
