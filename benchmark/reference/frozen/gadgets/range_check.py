# Frozen copy of starky_bn254_tpu_torch/gadgets/range_check.py at commit fb7d4c0,
# cut to what the verifier reaches: no tracegen, aux build, commitment,
# proof-of-work search or proof serialisation.
# Part of the benchmark's reference verifier: never edited to follow the port.
"""u16 range checks: the JAX package's flavours, by name (RangeCheckSpec).

(a) `u16`: one ascending 0..2^16 table column and, per checked column, a
    (col_perm, table_perm) pair proven by a permuted-column lookup against
    it (needs n >= 2^16; adds 1 + 2k columns). Reference
    src/utils/range_check.rs:20-47.
(b) `split`: an 8-bit table column; each checked u16 column is split into
    lo/hi bytes, each proven to lie in the table by a permuted-column lookup
    (works at any power-of-two height >= 256; adds 1 + 6k columns: per
    checked column [lo, lo_perm, table_perm, hi, hi_perm, table_perm]).
    Reference src/utils/range_check.rs:116-160.
(c) `logup`: the same byte split against an 8-bit table, proven by the
    log-derivative argument (stark/logup.py); adds 2 + 2k columns.
(d) `logup_u16`: a full 2^16 table and its multiplicity column, proven by
    the log-derivative argument; adds 2 columns, needs n >= 2^16.

Generation is vectorized numpy over all checked columns; evaluation is
lane-stacked.
"""

from __future__ import annotations

import numpy as np

from ..stark.consumer import ConstraintConsumer
from ..stark.field_expr import RowView
from ..utils.conversions import LIMB_BITS
from .lookup import eval_lookups


def _table(num_rows: int, range_max: int) -> np.ndarray:
    t = np.full(num_rows, range_max - 1, dtype=np.uint64)
    t[:range_max] = np.arange(range_max, dtype=np.uint64)
    return t


# ---------------------------------------------------------------------------
# flavour (a): the full u16 table, permuted columns
# ---------------------------------------------------------------------------


def eval_u16_range_check(
    cc: ConstraintConsumer,
    lv: RowView,
    nv: RowView,
    start_col: int,
    num_targets: int,
):
    perm_in = [start_col + 1 + 2 * i for i in range(num_targets)]
    perm_tb = [start_col + 2 + 2 * i for i in range(num_targets)]
    eval_lookups(cc, lv, nv, perm_in, perm_tb)
    _eval_table_shape(cc, lv, nv, start_col, (1 << LIMB_BITS) - 1)


def u16_range_check_pairs(
    start_col: int, target_cols: list[int]
) -> list[tuple[int, int]]:
    """Per checked column: table ~ table_perm, then col ~ col_perm (the
    permutation arguments' Z columns, in the JAX package's order)."""
    pairs = []
    for i, pos in enumerate(target_cols):
        pairs.append((start_col, start_col + 2 + 2 * i))
        pairs.append((pos, start_col + 1 + 2 * i))
    return pairs


def eval_split_u16_range_check(
    cc: ConstraintConsumer,
    lv: RowView,
    nv: RowView,
    start_col: int,
    target_cols: list[int],
):
    k = len(target_cols)
    lo_cols = [start_col + 1 + 6 * i for i in range(k)]
    hi_cols = [start_col + 4 + 6 * i for i in range(k)]
    # recomposition: col == lo + 2^8 * hi
    orig = lv.cols_idx(target_cols)
    lo = lv.cols_idx(lo_cols)
    hi = lv.cols_idx(hi_cols)
    cc.constraint(orig - (lo + hi * (1 << 8)))
    eval_lookups(
        cc,
        lv,
        nv,
        [c + 1 for c in lo_cols] + [c + 1 for c in hi_cols],
        [c + 2 for c in lo_cols] + [c + 2 for c in hi_cols],
    )
    _eval_table_shape(cc, lv, nv, start_col, (1 << 8) - 1)


def split_u16_range_check_pairs(
    start_col: int, num_targets: int
) -> list[tuple[int, int]]:
    pairs = []
    for i in range(num_targets):
        base = start_col + 1 + 6 * i
        pairs.append((start_col, base + 2))  # table ~ lo table_perm
        pairs.append((start_col, base + 5))  # table ~ hi table_perm
        pairs.append((base, base + 1))  # lo ~ lo_perm
        pairs.append((base + 3, base + 4))  # hi ~ hi_perm
    return pairs


# ---------------------------------------------------------------------------
# flavour (c): logUp with an 8-bit table (works at any height >= 256)
# ---------------------------------------------------------------------------


def eval_logup_range_check(
    cc: ConstraintConsumer,
    lv: RowView,
    nv: RowView,
    start_col: int,
    target_cols: list[int],
):
    """Trace-side constraints only: byte recomposition + table shape. The
    logUp sum constraints are emitted by the framework from lookup_tables()."""
    k = len(target_cols)
    lo_cols = [start_col + 2 + 2 * i for i in range(k)]
    hi_cols = [start_col + 3 + 2 * i for i in range(k)]
    orig = lv.cols_idx(target_cols)
    lo = lv.cols_idx(lo_cols)
    hi = lv.cols_idx(hi_cols)
    cc.constraint(orig - (lo + hi * (1 << 8)))
    _eval_table_shape(cc, lv, nv, start_col, (1 << 8) - 1)


def logup_range_check_tables(start_col: int, num_targets: int):
    checked = []
    for i in range(num_targets):
        checked += [start_col + 2 + 2 * i, start_col + 3 + 2 * i]
    return [(start_col, start_col + 1, tuple(checked))]


# ---------------------------------------------------------------------------
# flavour (d): logUp with the full 2^16 table
# ---------------------------------------------------------------------------


class RangeCheckSpec:
    """Uniform interface over the range-check flavours.

    flavor: "u16" (full 2^16 table + permutation argument, n >= 2^16),
            "split" (8-bit table + permutation argument),
            "logup" (8-bit table + log-derivative argument),
            "logup_u16" (2^16 table + log-derivative, n >= 2^16).
    """

    def __init__(self, flavor: str, start_col: int, target_cols: list[int]):
        assert flavor in ("u16", "split", "logup", "logup_u16")
        self.flavor = flavor
        self.start_col = start_col
        self.targets = list(target_cols)
        k = len(self.targets)
        self.num_added = {"u16": 1 + 2 * k, "split": 1 + 6 * k, "logup": 2 + 2 * k,
                          "logup_u16": 2}[flavor]

    def eval(self, cc, lv, nv):
        if self.flavor == "u16":
            eval_u16_range_check(cc, lv, nv, self.start_col, len(self.targets))
        elif self.flavor == "split":
            eval_split_u16_range_check(cc, lv, nv, self.start_col, self.targets)
        elif self.flavor == "logup_u16":
            _eval_table_shape(cc, lv, nv, self.start_col, (1 << 16) - 1)
        else:
            eval_logup_range_check(cc, lv, nv, self.start_col, self.targets)

    def pairs(self) -> list[tuple[int, int]]:
        if self.flavor == "u16":
            return u16_range_check_pairs(self.start_col, self.targets)
        if self.flavor == "split":
            return split_u16_range_check_pairs(self.start_col, len(self.targets))
        return []

    def tables(self):
        if self.flavor == "logup":
            return logup_range_check_tables(self.start_col, len(self.targets))
        if self.flavor == "logup_u16":
            return [(self.start_col, self.start_col + 1, tuple(self.targets))]
        return []


def _eval_table_shape(cc, lv, nv, table_col: int, range_max_m1: int):
    cur = lv.col(table_col)
    nxt = nv.col(table_col)
    cc.constraint_first_row(cur)
    incr = nxt - cur
    cc.constraint_transition(incr * incr - incr)
    cc.constraint_last_row(cur - range_max_m1)
