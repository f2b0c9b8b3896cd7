# Frozen copy of starky_bn254_tpu_torch/gadgets/fq2.py at commit eed7dfc,
# cut to what the verifier reaches: no tracegen, aux build, commitment,
# proof-of-work search or proof serialisation.
# Part of the benchmark's reference verifier: never edited to follow the port.
"""Fq2 limb-polynomial algebra: complex-style ops over pairs of limb vectors.

Re-derivation of reference src/fields/fq2.rs (Fq2 = Fq[u]/(u^2 + 1)):
an Fq2 value is a pair (c0, c1) of 16-limb vectors; products fold u^2 = -1.
Constraint-side only — witness generation uses exact ints in bn254.py.
"""

from __future__ import annotations

from ..utils.conversions import N_LIMBS
from .limbs import lane_pad, pol_mul_wide

Fq2Val = tuple  # (Val, Val)


def pol_mul_fq2(x: Fq2Val, y: Fq2Val) -> Fq2Val:
    """[(x0*y0 - x1*y1), (x0*y1 + x1*y0)], each widened to 31 lanes
    (reference fq2.rs:42-58)."""
    x0, x1 = x
    y0, y1 = y
    z0 = pol_mul_wide(x0, y0) - pol_mul_wide(x1, y1)
    z1 = pol_mul_wide(x0, y1) + pol_mul_wide(x1, y0)
    return (z0, z1)


def pol_add_fq2(x: Fq2Val, y: Fq2Val) -> Fq2Val:
    return (x[0] + y[0], x[1] + y[1])


def pol_sub_fq2(x: Fq2Val, y: Fq2Val) -> Fq2Val:
    return (x[0] - y[0], x[1] - y[1])


def pol_mul_scalar_fq2(x: Fq2Val, c: int) -> Fq2Val:
    return (x[0] * c, x[1] * c)


def to_wide_fq2(x: Fq2Val) -> Fq2Val:
    return (
        lane_pad(x[0], 2 * N_LIMBS - 1),
        lane_pad(x[1], 2 * N_LIMBS - 1),
    )
