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

import numpy as np

from .. import native
from ..gadgets import flags as fl
from ..gadgets import g2 as g2g
from ..gadgets import pulse as pu
from ..gadgets import range_check as rc
from ..gadgets.equals import vec_equal, vec_equal_transition
from ..gadgets.limbs import u16_to_u32_lanes
from ..stark.air import Air
from ..stark.field_expr import lane_concat
from ..stark.io_rlc import RlcIoBinding
from ..utils import timing as tm
from ..utils.conversions import N_LIMBS, fq_to_u32_limbs, int_to_limbs, limbs_to_int
from .g1_exp import _head, _tail

NUM_MAIN = 48 * N_LIMBS + fl.NUM_FLAGS_COLS  # 782
START_FLAGS = 48 * N_LIMBS  # 768
NUM_RANGE_CHECK = 48 * N_LIMBS - 6  # 762
RANGE_TARGETS = list(range(NUM_RANGE_CHECK))
G2_EXP_IO_LEN = 13 * fl.NUM_INPUT_LIMBS  # 104
ROWS_PER_BLOCK = fl.NUM_FLAG_ROWS  # 512


def _fq2_limb_array(values) -> np.ndarray:
    """Fq2 values -> [len, 2, 16] u64 limbs (component-major)."""
    return np.array([[int_to_limbs(v[0]), int_to_limbs(v[1])] for v in values], dtype=np.uint64)


def _limbs_fq2(limbs) -> tuple[int, int]:
    return (limbs_to_int(limbs[0]), limbs_to_int(limbs[1]))


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
            host_in_cells=self._host_in_cells,
            host_out_cells=self._host_out_cells,
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
        cells = self._u32_cells(trace, row, range(8))
        limbs = [int(v) for v in trace[row, s + 6 : s + 6 + fl.NUM_INPUT_LIMBS]]
        cells.append(limbs[0] * 2 + int(trace[row, s + 4]))
        cells += limbs[1:]
        return cells

    def _host_out_cells(self, trace, row):
        return self._u32_cells(trace, row, (4, 5, 6, 7))

    def generate_aux(self, trace, gammas):
        return self._rlc_binding().generate_aux(trace, gammas, self.num_io)

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
    def generate_trace_and_pi(self, inputs, exact: bool = False) -> tuple[np.ndarray, np.ndarray]:
        """inputs: per instance (x_point, offset_point, exp_val); points are
        ((x0,x1),(y0,y1)) Fq2 pairs. exact: run the exact-int Python gadgets
        row by row instead of the native chain (a test reference, slow).
        Spans of the current recorder (utils.timing): tracegen, and under it
        chain, oracle check, pulses and range check."""
        assert len(inputs) == self.num_io
        with tm.span("tracegen", rows=ROWS_PER_BLOCK * self.num_io):
            return self._trace_and_pi(inputs, exact)

    def _trace_and_pi(self, inputs, exact: bool) -> tuple[np.ndarray, np.ndarray]:
        io = self.num_io
        n = ROWS_PER_BLOCK * io

        exp_limbs = np.array(
            [fq_to_u32_limbs(e % (1 << 256)) for (_, _, e) in inputs], dtype=np.uint64
        )
        flag_rows = fl.generate_flag_columns(exp_limbs)
        # one buffer for the whole trace; every section is written in place
        trace_full = np.zeros((n, self.num_columns), dtype=np.uint64)
        m3 = trace_full.reshape(io, ROWS_PER_BLOCK, self.num_columns)
        main = m3[:, :, :NUM_MAIN]  # strided view over the main section
        main[:, :, START_FLAGS:] = flag_rows

        with tm.span("chain"):
            # [io, 2, 2, 16]: (x, y), each (c0, c1)
            x_limbs, off_limbs = (
                np.stack([_fq2_limb_array([inp[j][k] for inp in inputs]) for k in (0, 1)], 1)
                for j in (0, 1)
            )
            if exact:
                b_pt = self._exact_chain(inputs, flag_rows, main)
                fbx = _fq2_limb_array([b[0] for b in b_pt])
                fby = _fq2_limb_array([b[1] for b in b_pt])
            else:
                fbx, fby = native.g2_exp_chain(
                    x_limbs[:, 0], x_limbs[:, 1], off_limbs[:, 0], off_limbs[:, 1],
                    is_double=flag_rows[0, :, 2],
                    bits=flag_rows[:, :, 4],
                    main=m3,  # contiguous full-row view; writes cols [0, 768)
                    coord_off=0,
                    cells_off=8 * N_LIMBS,
                )
                b_pt = [(_limbs_fq2(fbx[i]), _limbs_fq2(fby[i])) for i in range(io)]

        # oracle check (the reference's G2 trace generation asserts the
        # same): g2_add(g2_mul(x, e), offset) of every instance in one
        # native call
        with tm.span("oracle check", instances=io):
            expected, at_infinity = native.exp_oracle(
                "oracle_g2_exp", x_limbs, off_limbs, [e for (_, _, e) in inputs]
            )
            assert not at_infinity.any() and np.array_equal(
                expected, np.stack([fbx, fby], 1)
            ), "G2 trace generation mismatch vs oracle"

        trace = trace_full[:, :NUM_MAIN]
        with tm.span("pulses"):
            trace_full[:, NUM_MAIN : NUM_MAIN + 2] = pu.generate_periodic_pulse_witness(
                trace[:, START_FLAGS + 1],
                2 * fl.INPUT_LIMB_BITS,
                2 * fl.INPUT_LIMB_BITS - 2,
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
        with tm.span("range check"):
            trace_full[:, self.start_lookups :] = self.rc_spec.generate(
                trace_full[:, : self.start_lookups]
            )

        pi = []
        for i, (x, off, e) in enumerate(inputs):
            for v in [x[0][0], x[0][1], x[1][0], x[1][1]]:
                pi += fq_to_u32_limbs(v)
            for v in [off[0][0], off[0][1], off[1][0], off[1][1]]:
                pi += fq_to_u32_limbs(v)
            pi += fq_to_u32_limbs(e % (1 << 256))
            bx, by = b_pt[i]
            for v in [bx[0], bx[1], by[0], by[1]]:
                pi += fq_to_u32_limbs(v)
        return trace_full, np.array(pi, dtype=np.uint64)

    @staticmethod
    def _exact_chain(inputs, flag_rows, main) -> list:
        """The double-and-add chain with the exact-int gadgets, one row and
        one instance at a time; writes main[i, r, :768]. Returns the final
        accumulators."""
        a_pt = [p for (p, _, _) in inputs]
        b_pt = [q for (_, q, _) in inputs]
        for r in range(ROWS_PER_BLOCK):
            for i in range(len(inputs)):
                (axi, ayi), (bxi, byi) = a_pt[i], b_pt[i]
                coords = [axi[0], axi[1], ayi[0], ayi[1], bxi[0], bxi[1], byi[0], byi[1]]
                for k, v in enumerate(coords):
                    main[i, r, k * N_LIMBS : (k + 1) * N_LIMBS] = int_to_limbs(v)
                if flag_rows[i, r, 2] == 1:
                    w = g2g.generate_g2_double(a_pt[i])
                    a_pt[i] = (w["new_x"], w["new_y"])
                elif flag_rows[i, r, 4] == 1:
                    w = g2g.generate_g2_add(a_pt[i], b_pt[i])
                    b_pt[i] = (w["new_x"], w["new_y"])
                else:
                    w = g2g.zero_g2_output()
                main[i, r, 8 * N_LIMBS : 48 * N_LIMBS] = np.array(w["cells"], dtype=np.uint64)
        return b_pt

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
