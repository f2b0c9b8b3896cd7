"""AIR interface: the contract between a constraint system and the prover.

Replaces the reference's `starky::stark::Stark` trait surface
(`eval_packed_generic`, `eval_ext_circuit`, `constraint_degree`,
`permutation_pairs` — e.g. reference src/fields/fq/exp.rs:288-554) with an
array-first equivalent: one polymorphic `eval` runs for both prover and
verifier, and the trace is produced as a whole [rows, cols] array.
"""

from __future__ import annotations

from .consumer import ConstraintConsumer
from .field_expr import PublicInputsView, RowView


class Air:
    """Subclass and provide: num_columns, num_public_inputs, eval()."""

    num_columns: int
    num_public_inputs: int
    constraint_degree: int = 3

    def permutation_pairs(self) -> list[tuple[int, int]]:
        """Pairs (a, b) of columns whose values must be equal as multisets
        (the reference's `PermutationPair::singletons`, used by the
        lookup-based range checks — src/utils/range_check.rs:96-113)."""
        return []

    def lookup_tables(self) -> list[tuple[int, int, tuple[int, ...]]]:
        """logUp (log-derivative) lookups: (table_col, mult_col,
        checked_cols). Proves every checked cell appears in the table via
            sum_cells 1/(gamma + cell) == sum_rows mult/(gamma + table)
        (stark/logup.py builds the aux columns and emits the constraints)."""
        return []

    def aux_extra_width(self) -> int:
        """Number of AIR-defined auxiliary columns per challenge (committed in
        the second phase alongside Z/logUp columns; challenge-dependent)."""
        return 0

    def generate_aux(self, trace, gammas: list[int]):
        """Builds the AIR-defined aux columns on the host:
        trace [n, C] numpy -> [n, len(gammas) * aux_extra_width()] uint64."""
        raise NotImplementedError

    def eval_extra(self, lv, nv, aux_lv, aux_nv, gammas, pi, cc, aux_offset: int):
        """Constraints over the AIR-defined aux columns (both prover rows and
        verifier scalars); aux_offset = first AIR-aux column index inside the
        aux commitment."""
        raise NotImplementedError

    def eval(
        self,
        lv: RowView,
        nv: RowView,
        pi: PublicInputsView,
        cc: ConstraintConsumer,
    ) -> None:
        raise NotImplementedError
