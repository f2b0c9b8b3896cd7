"""G1 scalar-multiplication AIR: proves output = x * s + offset on BN254 G1.

Equivalent of the reference `G1ExpStark` (src/curves/g1/exp.rs): double-and-
add over the 512-row flag machine — doubles fire on `a` rows (flag col 2),
conditional adds on bit rows (filtered_bit, flag col 4). The `a` register
holds the running doubled point, `b` the accumulator seeded with `offset`
(offset-seeding makes incomplete addition safe and enables MSM chaining,
reference circuit.rs:458-509).

Row layout (reference g1/exp.rs:1-34):
  [ a_x a_y b_x b_y (4*16) | G1Output(320) | flags(14) ]   = 398 main cols
  + periodic(2) + io-pulses(1+4*num_io) or final-periodic(2)
  + range check over cols 0..380.
Public IO per instance (7*8 u32 cells): x, offset, exp_val, output.

The port of the JAX package's airs/g1_exp.py. Trace generation runs the
whole double-and-add chain in one native call (native.g1_exp_chain);
`generate_trace_and_pi(..., exact=True)` runs the exact-int Python gadgets
instead, as the reference the tests hold the native chain against.
"""

from __future__ import annotations

import numpy as np

from .. import native
from ..gadgets import flags as fl
from ..gadgets import g1 as g1g
from ..gadgets import g1_batch as gb
from ..gadgets import pulse as pu
from ..gadgets import range_check as rc
from ..gadgets.equals import vec_equal, vec_equal_transition
from ..gadgets.limbs import u16_to_u32_lanes
from ..stark.air import Air
from ..stark.field_expr import Val, lane_concat
from ..stark.io_rlc import RlcIoBinding
from ..utils import timing as tm
from ..utils.conversions import N_LIMBS, fq_to_u32_limbs, int_to_limbs

NUM_MAIN = 24 * N_LIMBS + fl.NUM_FLAGS_COLS  # 398
START_FLAGS = 24 * N_LIMBS  # 384
NUM_RANGE_CHECK = 24 * N_LIMBS - 3  # 381 (everything except the 3 signs)
RANGE_TARGETS = list(range(NUM_RANGE_CHECK))
G1_EXP_IO_LEN = 7 * fl.NUM_INPUT_LIMBS  # 56
ROWS_PER_BLOCK = fl.NUM_FLAG_ROWS  # 512


def _head(v: Val) -> Val:
    """Lane 0 of a lane stack, kept as a one-lane stack."""
    return Val(v.arr[..., 0:1, :] if v.ext else v.arr[..., 0:1], v.ext)


def _tail(v: Val) -> Val:
    """Lanes 1.. of a lane stack."""
    return Val(v.arr[..., 1:, :] if v.ext else v.arr[..., 1:], v.ext)


class G1ExpAir(Air):
    """io_binding:
    - "pulse": the reference's per-instance one-hot IO pulses
      (1 + 4*num_io columns — g1/exp.rs io_pulses block);
    - "rlc": challenge-weighted running-sum binding (~4 fixed columns +
      2 aux per challenge), enabling num_io in the thousands. The is_final
      flag is pinned by a periodic pulse instead of the pulse sum.
    """

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
        self.num_public_inputs = G1_EXP_IO_LEN * num_io

    def aux_extra_width(self) -> int:
        return 2 if self.io_binding == "rlc" else 0

    def pulse_positions(self) -> list[int]:
        pos = []
        for i in range(self.num_io):
            pos += [i * ROWS_PER_BLOCK, i * ROWS_PER_BLOCK + ROWS_PER_BLOCK - 1]
        return pos

    # ------------------------------------------------------------------ trace
    def generate_trace_and_pi(
        self, inputs: list[tuple[tuple, tuple, int]], exact: bool = False
    ) -> tuple[np.ndarray, np.ndarray]:
        """inputs: per instance (x_point, offset_point, exp_val) with points
        as (x, y) int tuples. exact: run the exact-int Python gadgets row by
        row instead of the native chain (a test reference, slow). Spans of
        the current recorder (utils.timing): tracegen, and under it chain,
        oracle check, pulses and range check."""
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
            ax, ay = gb.points_to_limbs([p for (p, _, _) in inputs])
            bx, by = gb.points_to_limbs([q for (_, q, _) in inputs])
            if exact:
                b_pt = self._exact_chain(inputs, flag_rows, main)
                fbx, fby = gb.points_to_limbs(b_pt)
            else:
                fbx, fby = native.g1_exp_chain(
                    ax, ay, bx, by,
                    is_double=flag_rows[0, :, 2],
                    bits=flag_rows[:, :, 4],
                    main=m3,  # contiguous full-row view; writes cols [0, 384)
                    coord_off=0,
                    cells_off=4 * N_LIMBS,
                )
                b_pt = [gb.limbs_to_point(fbx[i], fby[i]) for i in range(io)]

        # oracle check (reference g1/exp.rs:279-285): g1_add(g1_mul(x, e),
        # offset) of every instance in one native call
        with tm.span("oracle check", instances=io):
            expected, at_infinity = native.exp_oracle(
                "oracle_g1_exp", np.stack([ax, ay], 1), np.stack([bx, by], 1),
                [e for (_, _, e) in inputs],
            )
            assert not at_infinity.any() and np.array_equal(
                expected, np.stack([fbx, fby], 1)
            ), "G1 trace generation mismatch vs oracle"

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
                # pin is_final itself as periodic (period 512, pulse at 511)
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
            pi += fq_to_u32_limbs(x[0]) + fq_to_u32_limbs(x[1])
            pi += fq_to_u32_limbs(off[0]) + fq_to_u32_limbs(off[1])
            pi += fq_to_u32_limbs(e % (1 << 256))
            pi += fq_to_u32_limbs(b_pt[i][0]) + fq_to_u32_limbs(b_pt[i][1])
        return trace_full, np.array(pi, dtype=np.uint64)

    @staticmethod
    def _exact_chain(inputs, flag_rows, main) -> list[tuple[int, int]]:
        """The double-and-add chain with the exact-int gadgets, one row and
        one instance at a time; writes main[i, r, :384]. Returns the final
        accumulators."""
        a_pt = [p for (p, _, _) in inputs]
        b_pt = [q for (_, q, _) in inputs]
        for r in range(ROWS_PER_BLOCK):
            for i in range(len(inputs)):
                (axi, ayi), (bxi, byi) = a_pt[i], b_pt[i]
                main[i, r, 0:N_LIMBS] = int_to_limbs(axi)
                main[i, r, N_LIMBS : 2 * N_LIMBS] = int_to_limbs(ayi)
                main[i, r, 2 * N_LIMBS : 3 * N_LIMBS] = int_to_limbs(bxi)
                main[i, r, 3 * N_LIMBS : 4 * N_LIMBS] = int_to_limbs(byi)
                if flag_rows[i, r, 2] == 1:
                    w = g1g.generate_g1_double(axi, ayi)
                    a_pt[i] = (w["new_x_int"], w["new_y_int"])
                elif flag_rows[i, r, 4] == 1:
                    w = g1g.generate_g1_add(axi, ayi, bxi, byi)
                    b_pt[i] = (w["new_x_int"], w["new_y_int"])
                else:
                    w = g1g.zero_g1_output()
                main[i, r, 4 * N_LIMBS : 24 * N_LIMBS] = np.array(w["cells"], dtype=np.uint64)
        return b_pt

    def permutation_pairs(self):
        return self.rc_spec.pairs()

    def lookup_tables(self):
        return self.rc_spec.tables()

    # ------------------------------------------------------------ constraints
    def eval(self, lv, nv, pi, cc):
        io = self.num_io
        s = START_FLAGS
        a_x = lv.cols(0, N_LIMBS)
        a_y = lv.cols(N_LIMBS, 2 * N_LIMBS)
        b_x = lv.cols(2 * N_LIMBS, 3 * N_LIMBS)
        b_y = lv.cols(3 * N_LIMBS, 4 * N_LIMBS)
        out = g1g.G1OutputView(lv, 4 * N_LIMBS)

        is_final = lv.col(s)
        is_dbl = lv.col(s + 2)
        is_add = lv.col(s + 4)
        not_final = 1 - is_final

        if self.io_binding == "pulse":
            out_pulse_cols = [
                pu.get_pulse_col(self.start_io_pulses, 2 * i + 1) for i in range(io)
            ]
            sum_out = None
            for pc in out_pulse_cols:
                v = lv.col(pc)
                sum_out = v if sum_out is None else sum_out + v
            cc.constraint(is_final - sum_out)

            # public IO
            ax32, ay32 = u16_to_u32_lanes(a_x), u16_to_u32_lanes(a_y)
            bx32, by32 = u16_to_u32_lanes(b_x), u16_to_u32_lanes(b_y)
            limbs = lv.cols(s + 6, s + 6 + fl.NUM_INPUT_LIMBS)
            restored0 = _head(limbs) * 2 + is_add.lane()
            rest = _tail(limbs)
            for i in range(io):
                off = G1_EXP_IO_LEN * i
                xx = pi.cols(off, off + 8)
                xy = pi.cols(off + 8, off + 16)
                ox = pi.cols(off + 16, off + 24)
                oy = pi.cols(off + 24, off + 32)
                ev = pi.cols(off + 32, off + 40)
                ux = pi.cols(off + 40, off + 48)
                uy = pi.cols(off + 48, off + 56)
                is_in = lv.col(pu.get_pulse_col(self.start_io_pulses, 2 * i))
                is_out = lv.col(pu.get_pulse_col(self.start_io_pulses, 2 * i + 1))
                vec_equal(cc, is_in, xx, ax32)
                vec_equal(cc, is_in, xy, ay32)
                vec_equal(cc, is_in, ox, bx32)
                vec_equal(cc, is_in, oy, by32)
                vec_equal(cc, is_out, ux, bx32)
                vec_equal(cc, is_out, uy, by32)
                vec_equal(cc, is_in, _head(ev), restored0)
                vec_equal(cc, is_in, _tail(ev), rest)
        else:
            # rlc mode: is_final pinned as a periodic pulse; PI equality via
            # the challenge-weighted accumulator (eval_extra). First/last-row
            # direct RLC bindings happen in eval_extra too (they need gamma).
            pu.eval_periodic_pulse(
                cc,
                lv,
                nv,
                START_FLAGS,
                self.start_final_periodic,
                ROWS_PER_BLOCK,
                ROWS_PER_BLOCK - 1,
            )

        # state transition
        n_ax = nv.cols(0, N_LIMBS)
        n_ay = nv.cols(N_LIMBS, 2 * N_LIMBS)
        n_bx = nv.cols(2 * N_LIMBS, 3 * N_LIMBS)
        n_by = nv.cols(3 * N_LIMBS, 4 * N_LIMBS)
        vec_equal_transition(cc, not_final * is_dbl, n_ax, out.new_x)
        vec_equal_transition(cc, not_final * is_dbl, n_ay, out.new_y)
        vec_equal_transition(cc, not_final * is_dbl, n_bx, b_x)
        vec_equal_transition(cc, not_final * is_dbl, n_by, b_y)
        vec_equal_transition(cc, not_final * is_add, n_ax, a_x)
        vec_equal_transition(cc, not_final * is_add, n_ay, a_y)
        vec_equal_transition(cc, not_final * is_add, n_bx, out.new_x)
        vec_equal_transition(cc, not_final * is_add, n_by, out.new_y)
        neither = 1 - is_dbl - is_add
        vec_equal_transition(cc, not_final * neither, n_ax, a_x)
        vec_equal_transition(cc, not_final * neither, n_ay, a_y)
        vec_equal_transition(cc, not_final * neither, n_bx, b_x)
        vec_equal_transition(cc, not_final * neither, n_by, b_y)

        fl.eval_flags(cc, lv, nv, START_FLAGS)
        g1g.eval_g1_double(cc, is_dbl, a_x, a_y, out)
        g1g.eval_g1_add(cc, is_add, a_x, a_y, b_x, b_y, out)

        pu.eval_periodic_pulse(
            cc,
            lv,
            nv,
            START_FLAGS + 1,
            self.start_periodic,
            2 * fl.INPUT_LIMB_BITS,
            2 * fl.INPUT_LIMB_BITS - 2,
        )
        if self.io_binding == "pulse":
            pu.eval_pulse(cc, lv, nv, self.start_io_pulses, self.pulse_positions())
        self.rc_spec.eval(cc, lv, nv)

    # ---------------------------------------------------- rlc IO binding aux
    def _rlc_binding(self) -> RlcIoBinding:
        return RlcIoBinding(
            io_len=G1_EXP_IO_LEN,
            in_len=40,
            rows_per_block=ROWS_PER_BLOCK,
            input_cells=self._input_cells,
            output_cells=self._output_cells,
            host_in_cells=self._host_in_cells,
            host_out_cells=self._host_out_cells,
        )

    def _input_cells(self, view):
        """40 input cells (x, offset u32 lanes; exp limbs with the first bit
        restored) read from a block-start row."""
        s = START_FLAGS
        coords = [
            u16_to_u32_lanes(view.cols(k * N_LIMBS, (k + 1) * N_LIMBS))
            for k in range(4)
        ]
        limbs = view.cols(s + 6, s + 6 + fl.NUM_INPUT_LIMBS)
        restored0 = _head(limbs) * 2 + view.col(s + 4).lane()
        return lane_concat(coords + [restored0, _tail(limbs)])

    def _output_cells(self, view):
        return lane_concat(
            [
                u16_to_u32_lanes(view.cols(2 * N_LIMBS, 3 * N_LIMBS)),
                u16_to_u32_lanes(view.cols(3 * N_LIMBS, 4 * N_LIMBS)),
            ]
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
        cells = self._u32_cells(trace, row, range(4))
        limbs = [int(v) for v in trace[row, s + 6 : s + 6 + fl.NUM_INPUT_LIMBS]]
        cells.append(limbs[0] * 2 + int(trace[row, s + 4]))
        cells += limbs[1:]
        return cells

    def _host_out_cells(self, trace, row):
        return self._u32_cells(trace, row, (2, 3))

    def generate_aux(self, trace, gammas):
        return self._rlc_binding().generate_aux(trace, gammas, self.num_io)

    def eval_extra(self, lv, nv, aux_lv, aux_nv, gammas, pi, cc, aux_offset):
        self._rlc_binding().eval_extra(
            lv,
            nv,
            aux_lv,
            aux_nv,
            gammas,
            pi,
            cc,
            aux_offset,
            is_final=lv.col(START_FLAGS),
            num_io=self.num_io,
        )
