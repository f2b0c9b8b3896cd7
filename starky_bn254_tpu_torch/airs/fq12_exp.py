"""Fq12 exponentiation AIR: output = offset * x^exp in the BN254 Fq12 tower.

Equivalent of reference `Fq12ExpStark` (src/fields/fq12/exp.rs): the same
512-row double-and-add machine as FqExpAir over 12-coefficient Fq12 values.

Row layout (fq12/exp.rs:1-34):
  [ a(12*16) | b(12*16) | Fq12Output(84*16) | flags(14) ]  = 1742 main cols
  + periodic(2) + io-pulses(1+4*num_io) or final-periodic(2)
  + range check over cols 24*N_LIMBS .. 108*N_LIMBS-12
    (outputs + aux; operands a/b are pinned by transition equality).
Public IO per instance (36*N_LIMBS + 8): x/offset/output as 12x16 u16 limbs,
exp_val as 8 u32 limbs.

The port of the JAX package's airs/fq12_exp.py. `Fq12ExpBase` holds the
layout, trace and constraints it shares with Fq12ExpU64Air
(fq12_exp_u64.py), which differs in its flag gadget and its exponent's
cells. Trace generation runs the
whole square-and-multiply chain in one native call (native.exp_chain with
"fq12_exp_chain"); `generate_trace_and_pi(..., exact=True)` runs the
exact-int Fq12 gadget instead, as the reference the tests hold the native
chain against.
"""

from __future__ import annotations

import numpy as np

from .. import bn254, native
from ..gadgets import flags as fl
from ..gadgets import fq12 as fq12g
from ..gadgets import pulse as pu
from ..gadgets import range_check as rc
from ..gadgets.equals import vec_equal, vec_equal_transition
from ..stark.air import Air
from ..stark.field_expr import lane_concat
from ..stark.io_rlc import RlcIoBinding
from ..utils.conversions import N_LIMBS, fq_to_u32_limbs, int_to_limbs, limbs_to_int
from .g1_exp import _head, _tail

NUM_MAIN = 108 * N_LIMBS + fl.NUM_FLAGS_COLS  # 1742
START_FLAGS = 108 * N_LIMBS
START_RANGE_CHECK = 24 * N_LIMBS
NUM_RANGE_CHECK = 84 * N_LIMBS - 12  # 1332
RANGE_TARGETS = list(range(START_RANGE_CHECK, START_RANGE_CHECK + NUM_RANGE_CHECK))
FQ12_EXP_IO_LEN = 36 * N_LIMBS + fl.NUM_INPUT_LIMBS  # 584
ROWS_PER_BLOCK = fl.NUM_FLAG_ROWS  # 512


def fq12_limb_array(values) -> np.ndarray:
    """Fq12 values -> [len, 12, 16] u64 limbs (the to_fq_list order)."""
    return np.array([[int_to_limbs(v) for v in f.to_fq_list()] for f in values],
                    dtype=np.uint64)


def limbs_fq12(limbs) -> "bn254.Fq12":
    """[12, 16] limbs -> Fq12."""
    return bn254.Fq12.from_fq_list([limbs_to_int(limbs[k]) for k in range(12)])


def exact_fq12_chain(inputs, is_square, bits, main) -> list:
    """The square-and-multiply chain with the exact-int Fq12 gadget, one row
    and one instance at a time: writes main[i, r, :108*16] (a, b, then the
    output block). is_square: [rows]; bits: [io, rows] (the multiply rows).
    Returns the final accumulators. Shared by both Fq12 AIRs."""
    a_val = [x for (x, _, _) in inputs]
    b_val = [off for (_, off, _) in inputs]
    for r in range(is_square.shape[0]):
        for i in range(len(inputs)):
            main[i, r, : 12 * N_LIMBS] = fq12_limb_array([a_val[i]]).reshape(-1)
            main[i, r, 12 * N_LIMBS : 24 * N_LIMBS] = fq12_limb_array([b_val[i]]).reshape(-1)
            if is_square[r] == 1:
                w = fq12g.generate_fq12_mul(a_val[i], a_val[i])
                a_val[i] = w["product"]
            elif bits[i, r] == 1:
                w = fq12g.generate_fq12_mul(a_val[i], b_val[i])
                b_val[i] = w["product"]
            else:
                w = fq12g.zero_fq12_output()
            main[i, r, 24 * N_LIMBS : 108 * N_LIMBS] = np.array(w["cells"], dtype=np.uint64)
    return b_val


def native_fq12_chain(inputs, is_square, bits, m3) -> list:
    """The same chain in one native call over the full-row view m3 [io, rows,
    num_columns]; writes cols [0, 108*16). Returns the final accumulators."""
    fb = native.exp_chain(
        "fq12_exp_chain",
        fq12_limb_array([x for (x, _, _) in inputs]),
        fq12_limb_array([off for (_, off, _) in inputs]),
        is_square=is_square, bits=bits, main=m3, coord_off=0, cells_off=24 * N_LIMBS,
    )
    return [limbs_fq12(fb[i]) for i in range(len(inputs))]


def eval_fq12_chain(cc, lv, nv, is_final, is_sq, is_mul):
    """The state transition and the two multiplies of both Fq12 AIRs: a and
    b (cols [0, 384)) carry on, squared or multiplied into, and the output
    block at col 384 binds the product under each filter. Returns (a, b)."""
    a = [lv.cols(k * N_LIMBS, (k + 1) * N_LIMBS) for k in range(12)]
    b = [lv.cols((12 + k) * N_LIMBS, (13 + k) * N_LIMBS) for k in range(12)]
    out = fq12g.Fq12OutputView(lv, 24 * N_LIMBS)
    n_a = [nv.cols(k * N_LIMBS, (k + 1) * N_LIMBS) for k in range(12)]
    n_b = [nv.cols((12 + k) * N_LIMBS, (13 + k) * N_LIMBS) for k in range(12)]
    not_final = 1 - is_final
    neither = 1 - is_sq - is_mul
    for k in range(12):
        vec_equal_transition(cc, not_final * is_sq, n_a[k], out.output[k])
        vec_equal_transition(cc, not_final * is_sq, n_b[k], b[k])
        vec_equal_transition(cc, not_final * is_mul, n_a[k], a[k])
        vec_equal_transition(cc, not_final * is_mul, n_b[k], out.output[k])
        vec_equal_transition(cc, not_final * neither, n_a[k], a[k])
        vec_equal_transition(cc, not_final * neither, n_b[k], b[k])
    return a, b, out


class Fq12ExpBase(Air):
    """What both Fq12 exp AIRs share: num_io instances of ROWS_PER_BLOCK
    rows, each [ a | b | Fq12Output | flags ] then PERIODIC_COLS periodic
    columns, the IO binding (pulse or rlc) and the range check. A subclass
    names its flag gadget and its exponent's cells: EXP_CELLS public cells,
    the squaring and multiply flags at SQ_FLAG and MUL_FLAG past
    START_FLAGS, and the hooks below."""

    NUM_MAIN: int
    IO_LEN: int
    ROWS_PER_BLOCK: int
    EXP_CELLS: int
    PERIODIC_COLS: int
    SQ_FLAG: int
    MUL_FLAG: int

    def __init__(self, num_io: int, range_check: str = "logup", io_binding: str = "auto"):
        self.num_io = num_io
        assert range_check in ("split", "logup")
        self.range_check = range_check
        if io_binding == "auto":
            io_binding = "rlc" if num_io >= 128 else "pulse"
        assert io_binding in ("pulse", "rlc")
        self.io_binding = io_binding
        first = self.NUM_MAIN + self.PERIODIC_COLS
        if io_binding == "pulse":
            self.start_io_pulses = first
            self.start_lookups = self.start_io_pulses + 1 + 4 * num_io
        else:
            self.start_final_periodic = first
            self.start_lookups = first + 2
        self.rc_spec = rc.RangeCheckSpec(range_check, self.start_lookups, RANGE_TARGETS)
        self.num_columns = self.start_lookups + self.rc_spec.num_added
        self.num_public_inputs = self.IO_LEN * num_io

    # ------------------------------------------------------ subclass hooks
    def _flag_rows(self, inputs) -> np.ndarray:
        """[io, ROWS_PER_BLOCK, flag columns] of the instances' exponents."""
        raise NotImplementedError

    def _exponent(self, e: int) -> int:
        """The exponent the chain raises x to."""
        raise NotImplementedError

    def _exp_public_cells(self, e: int) -> list[int]:
        """The EXP_CELLS public cells of an exponent."""
        raise NotImplementedError

    def _generate_periodic(self, trace_full: np.ndarray) -> None:
        """Fill the PERIODIC_COLS columns after the main section."""

    def _exp_row_cells(self, view, is_mul):
        """The exponent as a block-start row holds it (is_mul: that row's
        multiply flag, the exponent's low bit)."""
        raise NotImplementedError

    def _rlc_input_cells(self, view):
        """The instance's 24 * 16 + EXP_CELLS input cells (x, offset u16
        limbs, the exponent) read from a block-start row."""
        raise NotImplementedError

    def _host_exp_cells(self, flags) -> list[int]:
        """The exponent's input cells from a block-start row's flag words."""
        raise NotImplementedError

    def _eval_exp_io(self, cc, is_in, pi, off: int, row_cells) -> None:
        """Bind the exponent's public cells at pi[off:] to row_cells."""
        raise NotImplementedError

    def _eval_flags(self, cc, lv, nv) -> None:
        raise NotImplementedError

    def _eval_periodic(self, cc, lv, nv) -> None:
        """The PERIODIC_COLS columns' constraints."""

    # ---------------------------------------------------- rlc IO binding aux
    def aux_extra_width(self) -> int:
        return 2 if self.io_binding == "rlc" else 0

    def _host_in_cells(self, trace, row):
        cells = [int(v) for v in trace[row, : 24 * N_LIMBS]]
        return cells + self._host_exp_cells(trace[row, START_FLAGS:])

    def _rlc_binding(self) -> RlcIoBinding:
        return RlcIoBinding(
            io_len=self.IO_LEN,
            in_len=24 * N_LIMBS + self.EXP_CELLS,
            rows_per_block=self.ROWS_PER_BLOCK,
            input_cells=self._rlc_input_cells,
            output_cells=self._rlc_output_cells,
            host_in_cells=self._host_in_cells,
            host_out_cells=self._host_out_cells,
        )

    def _rlc_output_cells(self, view):
        return view.cols(12 * N_LIMBS, 24 * N_LIMBS)

    def _host_out_cells(self, trace, row):
        return [int(v) for v in trace[row, 12 * N_LIMBS : 24 * N_LIMBS]]

    def generate_aux(self, trace, gammas):
        return self._rlc_binding().generate_aux(trace, gammas, self.num_io)

    def eval_extra(self, lv, nv, aux_lv, aux_nv, gammas, pi, cc, aux_offset):
        self._rlc_binding().eval_extra(
            lv, nv, aux_lv, aux_nv, gammas, pi, cc, aux_offset,
            is_final=lv.col(START_FLAGS), num_io=self.num_io,
        )

    def pulse_positions(self) -> list[int]:
        rows = self.ROWS_PER_BLOCK
        pos = []
        for i in range(self.num_io):
            pos += [i * rows, i * rows + rows - 1]
        return pos

    # ------------------------------------------------------------------ trace
    def generate_trace_and_pi(self, inputs, exact: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """inputs: per instance (x: Fq12, offset: Fq12, exp_val: int). exact:
        run the exact-int Fq12 gadget row by row instead of the native chain
        (a test reference, slow)."""
        assert len(inputs) == self.num_io
        io, rows = self.num_io, self.ROWS_PER_BLOCK
        n = rows * io

        flag_rows = self._flag_rows(inputs)
        # one buffer for the whole trace; every section is written in place
        trace_full = np.zeros((n, self.num_columns), dtype=np.uint64)
        m3 = trace_full.reshape(io, rows, self.num_columns)
        main = m3[:, :, : self.NUM_MAIN]  # strided view over the main section
        main[:, :, START_FLAGS:] = flag_rows

        # squares on the SQ_FLAG rows (the same in every instance),
        # multiplies on each instance's MUL_FLAG rows
        is_square, bits = flag_rows[0, :, self.SQ_FLAG], flag_rows[:, :, self.MUL_FLAG]
        if exact:
            b_val = exact_fq12_chain(inputs, is_square, bits, main)
        else:
            b_val = native_fq12_chain(inputs, is_square, bits, m3)

        for i, (x, off, e) in enumerate(inputs):
            assert b_val[i].to_fq_list() == (off * x.pow(self._exponent(e))).to_fq_list(), (
                "Fq12 trace generation mismatch vs oracle"
            )

        self._generate_periodic(trace_full)
        if self.io_binding == "pulse":
            trace_full[:, self.start_io_pulses : self.start_lookups] = (
                pu.generate_pulse(n, self.pulse_positions())
            )
        else:
            trace_full[:, self.start_final_periodic : self.start_lookups] = (
                pu.generate_periodic_pulse_witness(trace_full[:, START_FLAGS], rows, rows - 1)
            )
        trace_full[:, self.start_lookups :] = self.rc_spec.generate(
            trace_full[:, : self.start_lookups]
        )

        pi = []
        for i, (x, off, e) in enumerate(inputs):
            pi += fq12_limb_array([x, off]).reshape(-1).tolist()
            pi += self._exp_public_cells(e)
            pi += fq12_limb_array([b_val[i]]).reshape(-1).tolist()
        return trace_full, np.array(pi, dtype=np.uint64)

    def permutation_pairs(self):
        return self.rc_spec.pairs()

    def lookup_tables(self):
        return self.rc_spec.tables()

    # ------------------------------------------------------------ constraints
    def eval(self, lv, nv, pi, cc):
        s = START_FLAGS
        is_final = lv.col(s)
        is_sq = lv.col(s + self.SQ_FLAG)
        is_mul = lv.col(s + self.MUL_FLAG)

        if self.io_binding == "rlc":
            pu.eval_periodic_pulse(
                cc, lv, nv, START_FLAGS, self.start_final_periodic,
                self.ROWS_PER_BLOCK, self.ROWS_PER_BLOCK - 1,
            )
        else:
            sum_out = None
            for i in range(self.num_io):
                v = lv.col(pu.get_pulse_col(self.start_io_pulses, 2 * i + 1))
                sum_out = v if sum_out is None else sum_out + v
            cc.constraint(is_final - sum_out)

            # public IO: direct u16 limb equality (fq12/exp.rs io format)
            a = [lv.cols(k * N_LIMBS, (k + 1) * N_LIMBS) for k in range(12)]
            b = [lv.cols((12 + k) * N_LIMBS, (13 + k) * N_LIMBS) for k in range(12)]
            row_exp = self._exp_row_cells(lv, is_mul)
            for i in range(self.num_io):
                off = self.IO_LEN * i
                is_in = lv.col(pu.get_pulse_col(self.start_io_pulses, 2 * i))
                is_out = lv.col(pu.get_pulse_col(self.start_io_pulses, 2 * i + 1))
                for k in range(24):  # x, then offset
                    vec_equal(cc, is_in, pi.cols(off + k * N_LIMBS, off + (k + 1) * N_LIMBS),
                              (a + b)[k])
                self._eval_exp_io(cc, is_in, pi, off + 24 * N_LIMBS, row_exp)
                off4 = off + 24 * N_LIMBS + self.EXP_CELLS
                for k in range(12):
                    vec_equal(cc, is_out, pi.cols(off4 + k * N_LIMBS, off4 + (k + 1) * N_LIMBS),
                              b[k])

        a, b, out = eval_fq12_chain(cc, lv, nv, is_final, is_sq, is_mul)
        self._eval_flags(cc, lv, nv)
        fq12g.eval_fq12_mul(cc, is_sq, a, a, out)
        fq12g.eval_fq12_mul(cc, is_mul, a, b, out)
        self._eval_periodic(cc, lv, nv)
        if self.io_binding == "pulse":
            pu.eval_pulse(cc, lv, nv, self.start_io_pulses, self.pulse_positions())
        self.rc_spec.eval(cc, lv, nv)


class Fq12ExpAir(Fq12ExpBase):
    """num_io independent `offset * x^exp` instances over Fq12, 512 rows
    each; exp is a 256-bit integer."""

    NUM_MAIN = NUM_MAIN
    IO_LEN = FQ12_EXP_IO_LEN
    ROWS_PER_BLOCK = ROWS_PER_BLOCK
    EXP_CELLS = fl.NUM_INPUT_LIMBS  # 8 u32 limbs
    PERIODIC_COLS = 2
    SQ_FLAG, MUL_FLAG = 2, 4
    start_periodic = NUM_MAIN

    def _flag_rows(self, inputs):
        exp_limbs = np.array([self._exp_public_cells(e) for (_, _, e) in inputs], dtype=np.uint64)
        return fl.generate_flag_columns(exp_limbs)  # [io, 512, 14]

    def _exponent(self, e):
        return e

    def _exp_public_cells(self, e):
        return fq_to_u32_limbs(e % (1 << 256))

    def _generate_periodic(self, trace_full):
        trace_full[:, NUM_MAIN : NUM_MAIN + 2] = pu.generate_periodic_pulse_witness(
            trace_full[:, START_FLAGS + 1], 2 * fl.INPUT_LIMB_BITS, 2 * fl.INPUT_LIMB_BITS - 2
        )

    def _rlc_input_cells(self, view):
        restored0, rest = self._exp_row_cells(view, view.col(START_FLAGS + self.MUL_FLAG))
        return lane_concat([view.cols(0, 24 * N_LIMBS), restored0, rest])

    def _exp_row_cells(self, view, is_mul):
        """(the first exponent limb with its low bit restored, the other
        seven)."""
        limbs = view.cols(START_FLAGS + 6, START_FLAGS + 6 + fl.NUM_INPUT_LIMBS)
        return _head(limbs) * 2 + is_mul.lane(), _tail(limbs)

    def _host_exp_cells(self, flags):
        limbs = [int(v) for v in flags[6 : 6 + fl.NUM_INPUT_LIMBS]]
        return [limbs[0] * 2 + int(flags[self.MUL_FLAG])] + limbs[1:]

    def _eval_exp_io(self, cc, is_in, pi, off, row_cells):
        ev = pi.cols(off, off + self.EXP_CELLS)
        restored0, rest = row_cells
        vec_equal(cc, is_in, _head(ev), restored0)
        vec_equal(cc, is_in, _tail(ev), rest)

    def _eval_flags(self, cc, lv, nv):
        fl.eval_flags(cc, lv, nv, START_FLAGS)

    def _eval_periodic(self, cc, lv, nv):
        pu.eval_periodic_pulse(
            cc, lv, nv, START_FLAGS + 1, self.start_periodic,
            2 * fl.INPUT_LIMB_BITS, 2 * fl.INPUT_LIMB_BITS - 2,
        )
