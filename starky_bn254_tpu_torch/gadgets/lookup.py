"""Halo2-style permuted-column lookup argument.

Re-derivation of reference src/utils/lookup.rs: for a (col, table) pair the
prover commits sorted/permuted copies (col_perm, table_perm) such that
col_perm is sorted and, wherever col_perm changes value, table_perm carries
the same value. Together with the multiset-equality permutation checks
(framework `permutation_pairs`), this proves every col value appears in the
table.

Witness construction here is vectorized numpy (sort + bincount) instead of
the reference's sort-merge loop (lookup.rs:60-111) — same committed columns
semantics, deterministic.
"""

from __future__ import annotations

import numpy as np

from ..stark.consumer import ConstraintConsumer
from ..stark.field_expr import RowView


def permuted_cols(col: np.ndarray, table: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Returns (col_perm, table_perm): col_perm = sorted(col); table_perm is a
    permutation of `table` with table_perm[i] == col_perm[i] at every position
    where col_perm[i] != col_perm[i-1] (including i = 0)."""
    n = len(col)
    assert len(table) == n
    s = np.sort(col.astype(np.uint64))
    new_mask = np.ones(n, dtype=bool)
    new_mask[1:] = s[1:] != s[:-1]
    used_vals = s[new_mask]

    # leftover = multiset(table) - {each used value once}
    max_val = int(table.max()) + 1
    cnt = np.bincount(table.astype(np.int64), minlength=max_val)
    used_cnt = np.bincount(used_vals.astype(np.int64), minlength=max_val)
    left = cnt - used_cnt
    assert (left >= 0).all(), "lookup value missing from table"
    leftover = np.repeat(np.arange(max_val, dtype=np.uint64), left)

    perm_table = np.empty(n, dtype=np.uint64)
    perm_table[new_mask] = used_vals
    perm_table[~new_mask] = leftover
    return s, perm_table


def eval_lookups(
    cc: ConstraintConsumer,
    lv: RowView,
    nv: RowView,
    perm_input_cols: list[int],
    perm_table_cols: list[int],
):
    """Lane-stacked lookup constraints over many (col_perm, table_perm) pairs
    at once (reference lookup.rs:13-34 evaluates them one by one):
      (next_in - cur_in) * (next_in - next_table) == 0  on every row (cyclic)
      next_in - next_table == 0 pinned at the last row (i.e. wraps to row 0).
    """
    cur_in = lv.cols_idx(perm_input_cols)
    next_in = nv.cols_idx(perm_input_cols)
    next_table = nv.cols_idx(perm_table_cols)
    diff_prev = next_in - cur_in
    diff_table = next_in - next_table
    cc.constraint(diff_prev * diff_table)
    cc.constraint_last_row(diff_table)
