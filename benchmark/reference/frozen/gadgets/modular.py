# Frozen copy of starky_bn254_tpu_torch/gadgets/modular.py at commit fb7d4c0,
# cut to what the verifier reaches: no tracegen, aux build, commitment,
# proof-of-work search or proof serialisation.
# Part of the benchmark's reference verifier: never edited to follow the port.
"""Modular-reduction gadget: the heart of every BN254 AIR.

Re-derivation of the reference's core trick (src/modular/modular.rs:38-257,
modular_zero.rs:33-171, addcy.rs:16-58): to prove c == input mod m with
16-bit limb polynomials, witness quotient q and auxiliary polynomial s with

    input(x) - c(x) - q(x) * m(x) = (x - beta) * s(x),   beta = 2^16,

which at x = beta collapses to the integer statement. `out_aux_red`
witnesses 2^256 - m + c so a u16 range check proves c < m via the carry-chain
gadget. Aux coefficients are offset by AUX_COEFF_ABS_MAX = 2^29 and split
into lo/hi u16 halves for range checking.

Witness side runs on the host with exact Python ints (vectorized over rows by
the callers); constraint side is lane-stacked Val algebra shared by prover
and verifier.
"""

from __future__ import annotations

from ..stark.consumer import ConstraintConsumer
from ..stark.field_expr import Val
from ..utils.conversions import N_LIMBS, int_to_limbs
from .limbs import BETA, const_lanes, lane_pad, pol_adjoin_root, pol_mul_wide

from .. import goldilocks as gl

AUX_COEFF_ABS_MAX = 1 << 29

# the modular-zero gadget's column footprint (reference modular_zero.rs:174-197)
AUX_ZERO_COLS = 5 * N_LIMBS - 1  # quot_abs(17) lo(31) hi(31)

GOLDILOCKS_INV_BETA = pow(BETA, gl.P - 2, gl.P)


# ----------------------------------------------------------------------------
# Witness generation (host, exact ints)
# ----------------------------------------------------------------------------


# ----------------------------------------------------------------------------
# Constraint evaluation (Val algebra; prover + verifier)
# ----------------------------------------------------------------------------


def eval_addcy(
    cc: ConstraintConsumer,
    filter_v: Val,
    x: Val,
    y: Val,
    z: Val,
    given_cy: Val,
    check_cy: bool = True,
):
    """Carry-chain addition: x + y == z + given_cy * 2^256 limb-wise
    (reference src/modular/addcy.rs:16-58). The carry recurrence forces a
    16-step chain; each step is one vectorized op."""
    from .limbs import lane_get

    inv_beta = GOLDILOCKS_INV_BETA
    cy = None
    ts = []
    for i in range(N_LIMBS):
        t = lane_get(x, i) + lane_get(y, i) - lane_get(z, i)
        if cy is not None:
            t = t + cy
        ts.append(t * (BETA - t))  # t in {0, 2^16}
        cy = t * inv_beta
    from ..stark.field_expr import stack_vals

    cc.constraint(filter_v.lane() * stack_vals(ts))
    cy0 = lane_get(given_cy, 0)
    if check_cy:
        cc.constraint(filter_v * (cy0 * (cy0 - 1)))
        rest = Val(
            given_cy.arr[..., 1:, :] if given_cy.ext else given_cy.arr[..., 1:],
            given_cy.ext,
        )
        cc.constraint(filter_v.lane() * rest)
    cc.constraint(filter_v * (cy - cy0))


def _aux_poly(aux_lo: Val, aux_hi: Val) -> Val:
    """Recombine offset-split aux columns into signed coefficients, padded to
    32 lanes: s_i = lo_i - 2^29 + 2^16 * hi_i (reference modular.rs:140-149)."""
    s = aux_lo - AUX_COEFF_ABS_MAX + aux_hi * BETA
    return lane_pad(s, 2 * N_LIMBS)


def eval_modular_op(
    cc: ConstraintConsumer,
    filter_v: Val,
    modulus: int,
    input_pol: Val,  # [.., 31]
    output: Val,  # [.., 16]
    quot_sign: Val,
    out_aux_red: Val,  # [.., 16]
    quot_abs: Val,  # [.., 17]
    aux_lo: Val,  # [.., 31]
    aux_hi: Val,  # [.., 31]
):
    ext = filter_v.ext
    m_lanes = const_lanes(int_to_limbs(modulus, N_LIMBS), ext)

    # output < modulus via m + out_aux_red == output + 2^256
    one_cy = const_lanes([1] + [0] * (N_LIMBS - 1), ext)
    eval_addcy(cc, filter_v, m_lanes, out_aux_red, output, one_cy, check_cy=False)

    cc.constraint(filter_v * (quot_sign * quot_sign - 1))
    quot = quot_sign.lane() * quot_abs  # [.., 17]

    constr = pol_mul_wide(quot, m_lanes)  # [.., 32]
    constr = constr + lane_pad(output, 2 * N_LIMBS)
    constr = constr + pol_adjoin_root(_aux_poly(aux_lo, aux_hi), BETA)
    constr = constr - lane_pad(input_pol, 2 * N_LIMBS)
    cc.constraint(filter_v.lane() * constr)


def eval_modular_zero(
    cc: ConstraintConsumer,
    filter_v: Val,
    modulus: int,
    input_pol: Val,  # [.., 31]
    quot_sign: Val,
    quot_abs: Val,  # [.., 17]
    aux_lo: Val,
    aux_hi: Val,
):
    ext = filter_v.ext
    m_lanes = const_lanes(int_to_limbs(modulus, N_LIMBS), ext)
    cc.constraint(filter_v * (quot_sign * quot_sign - 1))
    quot = quot_sign.lane() * quot_abs
    constr = pol_mul_wide(quot, m_lanes)
    constr = constr + pol_adjoin_root(_aux_poly(aux_lo, aux_hi), BETA)
    constr = constr - lane_pad(input_pol, 2 * N_LIMBS)
    cc.constraint(filter_v.lane() * constr)
