# Frozen copy of starky_bn254_tpu_torch/airs/g2_exp.py at commit eed7dfc,
# cut to what the verifier reaches: no tracegen, aux build, commitment,
# proof-of-work search or proof serialisation.
# Part of the benchmark's reference verifier: never edited to follow the port.
"""G2 scalar-multiplication AIR: output = x * s + offset on BN254 G2 (Fq2
coordinates). Equivalent of reference `G2ExpStark` (src/curves/g2/exp.rs).

Row layout (g2/exp.rs:1-34):
  [ a(4*16) | b(4*16) | G2Output(640) | flags(14) ]   = 782 main cols
  + periodic(2) + io-pulses(1+4*num_io) or final-periodic(2)
  + range check over the first 48*N_LIMBS - 6 cols (everything except the
  6 quotient signs).
Public IO per instance: 13*8 u32 cells (x, offset as 4 Fq each, exp_val,
output).

The port of the JAX package's airs/g2_exp.py. Trace generation runs the
whole double-and-add chain in one native call (native.g2_exp_chain);
`generate_trace_and_pi(..., exact=True)` runs the exact-int Python gadgets
instead, as the reference the tests hold the native chain against.
"""

from __future__ import annotations

from ..gadgets import flags as fl
from ..gadgets import g2 as g2g
from ..gadgets import pulse as pu
from ..gadgets import range_check as rc
from ..gadgets.equals import vec_equal, vec_equal_transition
from ..gadgets.limbs import u16_to_u32_lanes
from ..stark.air import Air
from ..stark.field_expr import lane_concat
from ..stark.io_rlc import RlcIoBinding
from ..utils.conversions import N_LIMBS
from .g1_exp import _head, _tail

NUM_MAIN = 48 * N_LIMBS + fl.NUM_FLAGS_COLS  # 782
START_FLAGS = 48 * N_LIMBS  # 768
NUM_RANGE_CHECK = 48 * N_LIMBS - 6  # 762
RANGE_TARGETS = list(range(NUM_RANGE_CHECK))
G2_EXP_IO_LEN = 13 * fl.NUM_INPUT_LIMBS  # 104
ROWS_PER_BLOCK = fl.NUM_FLAG_ROWS  # 512


class G2ExpAir(Air):
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
        self.num_public_inputs = G2_EXP_IO_LEN * num_io

    def aux_extra_width(self) -> int:
        return 2 if self.io_binding == "rlc" else 0

    # ---------------------------------------------------- rlc IO binding aux
    def _rlc_binding(self) -> RlcIoBinding:
        return RlcIoBinding(
            io_len=G2_EXP_IO_LEN,
            in_len=72,
            rows_per_block=ROWS_PER_BLOCK,
            input_cells=self._rlc_input_cells,
            output_cells=self._rlc_output_cells,
        )

    def _rlc_input_cells(self, view):
        """72 input cells (x, offset u32 lanes; exp limbs with the first bit
        restored) read from a block-start row."""
        s = START_FLAGS
        coords = [
            u16_to_u32_lanes(view.cols(k * N_LIMBS, (k + 1) * N_LIMBS))
            for k in range(8)
        ]
        limbs = view.cols(s + 6, s + 6 + fl.NUM_INPUT_LIMBS)
        restored0 = _head(limbs) * 2 + view.col(s + 4).lane()
        return lane_concat(coords + [restored0, _tail(limbs)])

    def _rlc_output_cells(self, view):
        return lane_concat(
            [u16_to_u32_lanes(view.cols(k * N_LIMBS, (k + 1) * N_LIMBS)) for k in (4, 5, 6, 7)]
        )

    def eval_extra(self, lv, nv, aux_lv, aux_nv, gammas, pi, cc, aux_offset):
        self._rlc_binding().eval_extra(
            lv, nv, aux_lv, aux_nv, gammas, pi, cc, aux_offset,
            is_final=lv.col(START_FLAGS), num_io=self.num_io,
        )

    def pulse_positions(self) -> list[int]:
        pos = []
        for i in range(self.num_io):
            pos += [i * ROWS_PER_BLOCK, i * ROWS_PER_BLOCK + ROWS_PER_BLOCK - 1]
        return pos

    # ------------------------------------------------------------------ trace
    def permutation_pairs(self):
        return self.rc_spec.pairs()

    def lookup_tables(self):
        return self.rc_spec.tables()

    # ------------------------------------------------------------ constraints
    def eval(self, lv, nv, pi, cc):
        io = self.num_io
        s = START_FLAGS

        def fq2_at(view, base):
            return (
                view.cols(base, base + N_LIMBS),
                view.cols(base + N_LIMBS, base + 2 * N_LIMBS),
            )

        a_x = fq2_at(lv, 0)
        a_y = fq2_at(lv, 2 * N_LIMBS)
        b_x = fq2_at(lv, 4 * N_LIMBS)
        b_y = fq2_at(lv, 6 * N_LIMBS)
        out = g2g.G2OutputView(lv, 8 * N_LIMBS)

        is_final = lv.col(s)
        is_dbl = lv.col(s + 2)
        is_add = lv.col(s + 4)
        not_final = 1 - is_final

        if self.io_binding == "rlc":
            pu.eval_periodic_pulse(
                cc, lv, nv, START_FLAGS, self.start_final_periodic,
                ROWS_PER_BLOCK, ROWS_PER_BLOCK - 1,
            )
        else:
            sum_out = None
            for i in range(io):
                v = lv.col(pu.get_pulse_col(self.start_io_pulses, 2 * i + 1))
                sum_out = v if sum_out is None else sum_out + v
            cc.constraint(is_final - sum_out)

            coords32 = [
                u16_to_u32_lanes(c)
                for c in [a_x[0], a_x[1], a_y[0], a_y[1], b_x[0], b_x[1], b_y[0], b_y[1]]
            ]
            limbs = lv.cols(s + 6, s + 6 + fl.NUM_INPUT_LIMBS)
            restored0 = _head(limbs) * 2 + is_add.lane()
            rest = _tail(limbs)
            for i in range(io):
                off = G2_EXP_IO_LEN * i
                is_in = lv.col(pu.get_pulse_col(self.start_io_pulses, 2 * i))
                is_out = lv.col(pu.get_pulse_col(self.start_io_pulses, 2 * i + 1))
                # x (4 fq), offset (4 fq)
                for k in range(8):
                    vec_equal(cc, is_in, pi.cols(off + 8 * k, off + 8 * k + 8), coords32[k])
                ev = pi.cols(off + 64, off + 72)
                vec_equal(cc, is_in, _head(ev), restored0)
                vec_equal(cc, is_in, _tail(ev), rest)
                for k in range(4):
                    vec_equal(cc, is_out, pi.cols(off + 72 + 8 * k, off + 80 + 8 * k),
                              coords32[4 + k])

        # state transition
        n_coords = [fq2_at(nv, k * 2 * N_LIMBS) for k in range(4)]
        cur = [a_x, a_y, b_x, b_y]
        new_a = [out.new_x, out.new_y, b_x, b_y]
        new_b = [a_x, a_y, out.new_x, out.new_y]
        neither = 1 - is_dbl - is_add
        for k in range(4):
            for c in range(2):
                vec_equal_transition(cc, not_final * is_dbl, n_coords[k][c], new_a[k][c])
                vec_equal_transition(cc, not_final * is_add, n_coords[k][c], new_b[k][c])
                vec_equal_transition(cc, not_final * neither, n_coords[k][c], cur[k][c])

        fl.eval_flags(cc, lv, nv, START_FLAGS)
        g2g.eval_g2_double(cc, is_dbl, a_x, a_y, out)
        g2g.eval_g2_add(cc, is_add, a_x, a_y, b_x, b_y, out)

        pu.eval_periodic_pulse(
            cc, lv, nv, START_FLAGS + 1, self.start_periodic,
            2 * fl.INPUT_LIMB_BITS, 2 * fl.INPUT_LIMB_BITS - 2,
        )
        if self.io_binding == "pulse":
            pu.eval_pulse(cc, lv, nv, self.start_io_pulses, self.pulse_positions())
        self.rc_spec.eval(cc, lv, nv)
