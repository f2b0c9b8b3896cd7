# Frozen copy of starky_bn254_tpu_torch/stark/prover.py at commit fb7d4c0,
# cut to what the verifier reaches: no tracegen, aux build, commitment,
# proof-of-work search or proof serialisation.
# Part of the benchmark's reference verifier: never edited to follow the port.
"""The two pieces of the port's prover that its verifier shares."""

from __future__ import annotations

QUOTIENT_CHUNKS = 2  # constraint degree 3 => quotient degree < 2n

def permutation_constraints(
    pairs: list[tuple[int, int]],
    gammas: list,
    lv: RowView,
    nv: RowView,
    z_lv: RowView,
    z_nv: RowView,
    cc: ConstraintConsumer,
    ext: bool,
):
    """Framework-added constraints for the permutation argument, in a fixed
    order: challenge-major, then pair index; first-row constraints then the
    cyclic transition constraints (lane-stacked per challenge)."""
    n_pairs = len(pairs)
    a_idx = [p[0] for p in pairs]
    b_idx = [p[1] for p in pairs]
    for ci, gamma in enumerate(gammas):
        zs = z_lv.cols_idx([ci * n_pairs + k for k in range(n_pairs)])
        zns = z_nv.cols_idx([ci * n_pairs + k for k in range(n_pairs)])
        avs = lv.cols_idx(a_idx)
        bvs = lv.cols_idx(b_idx)
        cc.constraint_first_row(zs - 1)
        # cyclic: Z(gx)*(b+gamma) - Z(x)*(a+gamma) == 0 on every row; at the
        # last row Z(gx) wraps to Z(first)=1, closing the product
        cc.constraint(zns * (bvs + gamma) - zs * (avs + gamma))
