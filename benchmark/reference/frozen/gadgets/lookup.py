# Frozen copy of starky_bn254_tpu_torch/gadgets/lookup.py at commit fb7d4c0,
# cut to what the verifier reaches: no tracegen, aux build, commitment,
# proof-of-work search or proof serialisation.
# Part of the benchmark's reference verifier: never edited to follow the port.
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


from ..stark.consumer import ConstraintConsumer
from ..stark.field_expr import RowView


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
