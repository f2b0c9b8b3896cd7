# Frozen copy of starky_bn254_tpu_torch/stark/composition.py at commit fb7d4c0,
# cut to what the verifier reaches: no tracegen, aux build, commitment,
# proof-of-work search or proof serialisation.
# Part of the benchmark's reference verifier: never edited to follow the port.
"""Row-blocked constraint composition.

The prover evaluates the AIR's constraints (plus the framework's
permutation and logUp constraints and the AIR's aux constraints) over every
LDE point: `air.eval` runs eagerly on int64 tensors over row blocks of the
LDE, on the LDE's device, and the `ConstraintConsumer` folds the
constraints with the alpha-Horner recurrence acc = acc * alpha^k + term in
the same order and with the same lane arithmetic as the verifier's replay
at zeta (`evaluate_composition_at_zeta`, which runs the identical
`air.eval` on host numpy extension scalars).

Constraint evaluation is row-local (lv/nv only), so a block needs just
`blowup` halo rows. The block height is chosen from the device's free
memory: the eval of a wide AIR holds about five [B, width] int64 words
per committed cell at its peak (`_TEMPS_PER_CELL`). An LDE offloaded to
the host is read one row block (with its halo) at a time onto the prove's
device. Over a mesh (`evaluate_composition_sharded`) each shard evaluates
its own row block on its own device, its halo rows from its right
neighbour.
"""

from __future__ import annotations

import numpy as np

from .air import Air
from .config import StarkConfig
from .consumer import ConstraintConsumer
from .field_expr import PublicInputsView, RowView, Val

# live int64 words per committed cell of a row block at the eval's peak,
# used only to size row blocks: 1.5x the larger of two measurements on an
# NVIDIA H100 80GB HBM3 (700.00 W), chip_smoke.py's composition probe, peak
# device memory above the composition's start over 8 * rows * (trace + aux
# columns): G2ExpAir(128) 5.44 (2 blocks of 65536 x 1558), Fq12ExpAir(128)
# 4.41 (16 blocks of 8192 x 7084). The estimate it replaces, 24, cut
# Fq12ExpAir(128)'s composition into 16 blocks.
# row-block budget on the CPU, bytes
def _emit_constraints(air: Air, lv, nv, z_lv, z_nv, pi, gammas_v, cc, ext: bool):
    """AIR constraints, then over the aux block [Z | logUp | extra] the
    framework's permutation constraints, the logUp constraints and the
    AIR's own aux constraints: the one order shared by prover and verifier
    (the JAX package's composition.py:105-122)."""
    from .logup import logup_constraints, table_aux_width
    from .prover import permutation_constraints

    air.eval(lv, nv, pi, cc)
    if z_lv is None:
        return
    nc = len(gammas_v)
    pairs = air.permutation_pairs()
    tables = air.lookup_tables()
    if pairs:
        permutation_constraints(pairs, gammas_v, lv, nv, z_lv, z_nv, cc, ext)
    if tables:
        logup_constraints(tables, gammas_v, lv, nv, z_lv, z_nv, cc, aux_offset=nc * len(pairs))
    if air.aux_extra_width():
        air.eval_extra(lv, nv, z_lv, z_nv, gammas_v, pi, cc,
                       aux_offset=nc * (len(pairs) + table_aux_width(tables)))


def evaluate_composition_at_zeta(
    air: Air,
    trace_zeta,
    trace_gzeta,
    z_zeta,
    z_gzeta,
    public_inputs,
    alphas: list[int],
    gammas: list[int],
    sel_z_last,
    sel_l_first,
    sel_l_last,
    cfg: StarkConfig,
) -> np.ndarray:
    """[nc, 2] alpha-combined constraint values at zeta (NOT divided by
    Z_H), on host numpy: the same constraints, in the same order, as the
    prover's row-block evaluation."""

    def ext_pair(x) -> np.ndarray:
        return np.array(x, dtype=np.uint64)

    lv = RowView(np.asarray(trace_zeta, dtype=np.uint64), ext=True)
    nv = RowView(np.asarray(trace_gzeta, dtype=np.uint64), ext=True)
    pi = PublicInputsView(np.asarray(public_inputs, dtype=np.uint64), ext=True)
    cc = ConstraintConsumer(
        [Val(ext_pair([a, 0]), True) for a in alphas],
        z_last=Val(ext_pair(sel_z_last), True),
        l_first=Val(ext_pair(sel_l_first), True),
        l_last=Val(ext_pair(sel_l_last), True),
    )
    z_lv = z_nv = None
    if z_zeta is not None:
        z_lv = RowView(np.asarray(z_zeta, dtype=np.uint64), ext=True)
        z_nv = RowView(np.asarray(z_gzeta, dtype=np.uint64), ext=True)
    gammas_v = [Val(ext_pair([g, 0]), True) for g in gammas]
    _emit_constraints(air, lv, nv, z_lv, z_nv, pi, gammas_v, cc, ext=True)
    return np.stack([np.asarray(a.arr, dtype=np.uint64) for a in cc.final_accs()])
