"""Lookup-based u16 range check, split flavour.

`split_u16`: an 8-bit table column; each checked u16 column is split into
lo/hi bytes, each proven to lie in the table by a permuted-column lookup
(works at any power-of-two height >= 256; adds 1 + 6k columns: per checked
column [lo, lo_perm, table_perm, hi, hi_perm, table_perm]). Reference
src/utils/range_check.rs:116-160. The JAX package's other flavours (full
u16 table, logUp) are not ported yet.

Generation is vectorized numpy over all checked columns; evaluation is
lane-stacked.
"""

from __future__ import annotations

import numpy as np

from ..stark.consumer import ConstraintConsumer
from ..stark.field_expr import RowView
from .lookup import eval_lookups, permuted_cols


def _table(num_rows: int, range_max: int) -> np.ndarray:
    t = np.full(num_rows, range_max - 1, dtype=np.uint64)
    t[:range_max] = np.arange(range_max, dtype=np.uint64)
    return t


def generate_split_u16_range_check(
    trace_cols: np.ndarray, target_cols: list[int]
) -> np.ndarray:
    """Returns appended columns [n, 1 + 6k]."""
    n = trace_cols.shape[0]
    range_max = 1 << 8
    assert n >= range_max and n & (n - 1) == 0
    table = _table(n, range_max)
    out = [table]
    for c in target_cols:
        col = trace_cols[:, c]
        assert (col < (1 << 16)).all()
        lo = col & 0xFF
        hi = col >> 8
        lo_perm, lo_table_perm = permuted_cols(lo, table)
        hi_perm, hi_table_perm = permuted_cols(hi, table)
        out += [lo, lo_perm, lo_table_perm, hi, hi_perm, hi_table_perm]
    return np.stack(out, axis=1)


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


def _eval_table_shape(cc, lv, nv, table_col: int, range_max_m1: int):
    cur = lv.col(table_col)
    nxt = nv.col(table_col)
    cc.constraint_first_row(cur)
    incr = nxt - cur
    cc.constraint_transition(incr * incr - incr)
    cc.constraint_last_row(cur - range_max_m1)
