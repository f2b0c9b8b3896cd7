# Frozen copy of starky_bn254_tpu_torch/stark/logup.py at commit fb7d4c0,
# cut to what the verifier reaches: no tracegen, aux build, commitment,
# proof-of-work search or proof serialisation.
# Part of the benchmark's reference verifier: never edited to follow the port.
"""logUp: log-derivative lookup argument (Habock-style running sums).

Proves every cell of the checked columns appears in a table column:

    sum_{rows, checked j} 1/(gamma + c_j)  ==  sum_rows m/(gamma + T)

with a committed multiplicity column m (part of the main trace) and, per
challenge gamma, auxiliary columns committed in the same phase as the
permutation Z columns:

    g       = m/(gamma + T)                       [1 col]
    h_b     = 1/(gamma+c_{2b}) + 1/(gamma+c_{2b+1})   [ceil(k/2) cols]
    S       = running sum of (sum_b h_b - g), S[0] = 0    [1 col]

Constraints (degree <= 3, all cyclic every-row):
    g*(gamma+T) - m == 0
    h_b*(gamma+c1)*(gamma+c2) - (2*gamma + c1 + c2) == 0   (pair batch)
    h_b*(gamma+c) - 1 == 0                                  (single tail)
    S(gx) - S(x) - (sum_b h_b(x) - g(x)) == 0

The cyclic S-recurrence telescopes to sum(delta) == 0, which is the logUp
identity. The columns and constraints are the JAX package's
stark/logup.py, in the same order, so the aux commitment is the same.

Two routes compute 1/(gamma + c) for the checked cells, with the same
canonical residues (`gl.batch_inv(gl.add(c, gamma))`):
* "fermat": a Fermat chain per cell, column chunk by column chunk;
* "table": every lookup in this framework is a u16 range check, so the
  denominators take at most 2^16 values: one 2^16-entry inverse table per
  challenge, and each checked cell becomes a gather.
`pick_route` takes the table from GATHER_MIN_CELLS checked cells up, on
the CPU and on the card alike (the JAX package kept the Fermat chains on
the TPU, whose gathers were slow; chip_smoke.py times both routes on the
H100 at the G1 shape, PERF.md records the numbers).
"""

from __future__ import annotations


from .. import goldilocks as gl
from .consumer import ConstraintConsumer
from .field_expr import RowView, Val

U16 = 1 << 16
GATHER_MIN_CELLS = 1 << 18  # rows x checked columns from which "table" is taken
FERMAT_CHUNK = 128  # checked columns inverted at once on the "fermat" route (even)


def batches(checked: tuple[int, ...]) -> list[tuple[int, ...]]:
    return [tuple(checked[i : i + 2]) for i in range(0, len(checked), 2)]


def table_aux_width(tables) -> int:
    """Aux columns per challenge."""
    return sum(2 + len(batches(t[2])) for t in tables)


def logup_constraints(
    tables,
    gammas: list[Val],
    lv: RowView,
    nv: RowView,
    aux_lv: RowView,
    aux_nv: RowView,
    cc: ConstraintConsumer,
    aux_offset: int,
):
    """Framework constraints; aux_offset = column where logup aux starts in
    the aux commitment (after permutation Z columns)."""
    w = table_aux_width(tables)
    for ci, gamma in enumerate(gammas):
        base = aux_offset + ci * w
        for (t_col, m_col, checked) in tables:
            bs = batches(checked)
            g_col = base
            h0 = base + 1
            s_col = base + 1 + len(bs)
            base += 2 + len(bs)

            g = aux_lv.col(g_col)
            t = lv.col(t_col)
            m = lv.col(m_col)
            cc.constraint(g * (t + gamma) - m)

            pair_i = [i for i, b in enumerate(bs) if len(b) == 2]
            if pair_i:
                h = aux_lv.cols_idx([h0 + i for i in pair_i])
                c1 = lv.cols_idx([bs[i][0] for i in pair_i])
                c2 = lv.cols_idx([bs[i][1] for i in pair_i])
                cc.constraint(
                    h * (c1 + gamma.lane()) * (c2 + gamma.lane())
                    - (c1 + c2 + gamma.lane() * 2)
                )
            single_i = [i for i, b in enumerate(bs) if len(b) == 1]
            if single_i:
                h = aux_lv.cols_idx([h0 + i for i in single_i])
                c1 = lv.cols_idx([bs[i][0] for i in single_i])
                cc.constraint(h * (c1 + gamma.lane()) - 1)

            all_h = aux_lv.cols(h0, h0 + len(bs))
            axis = -2 if all_h.ext else -1
            h_sum = Val(gl.sum_mod(all_h.arr, axis=axis), all_h.ext)
            s = aux_lv.col(s_col)
            s_next = aux_nv.col(s_col)
            cc.constraint(s_next - s - (h_sum - g))
