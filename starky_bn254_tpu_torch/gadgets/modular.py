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
from ..utils.conversions import (
    LIMB_BITS,
    N_LIMBS,
    int_to_limbs,
    int_to_signed_limbs,
    signed_limbs_to_int,
)
from .limbs import BETA, const_lanes, lane_pad, pol_adjoin_root, pol_mul_wide

from .. import goldilocks as gl

AUX_COEFF_ABS_MAX = 1 << 29

# the modular-zero gadget's column footprint (reference modular_zero.rs:174-197)
AUX_ZERO_COLS = 5 * N_LIMBS - 1  # quot_abs(17) lo(31) hi(31)

GOLDILOCKS_INV_BETA = pow(BETA, gl.P - 2, gl.P)


# ----------------------------------------------------------------------------
# Witness generation (host, exact ints)
# ----------------------------------------------------------------------------


def _divide_by_x_minus_beta(coeffs: list[int]) -> list[int]:
    """Exact quotient of a(x) by the monic (x - beta); remainder must be 0.

    Top-down synthetic division (division-free => no exactness pitfalls):
    q_{d-1} = a_d; q_{i-1} = a_i + beta * q_i; remainder a_0 + beta*q_0 == 0.
    """
    d = len(coeffs) - 1
    q = [0] * d
    q[d - 1] = coeffs[d]
    for i in range(d - 1, 0, -1):
        q[i - 1] = coeffs[i] + BETA * q[i]
    assert coeffs[0] + BETA * q[0] == 0, "x - beta does not divide the poly"
    return q


def _aux_split(aux_limbs: list[int]) -> tuple[list[int], list[int]]:
    lo, hi = [], []
    for c in aux_limbs:
        v = c + AUX_COEFF_ABS_MAX
        assert 0 <= v <= 2 * AUX_COEFF_ABS_MAX, "aux coefficient out of range"
        lo.append(v & (BETA - 1))
        hi.append(v >> LIMB_BITS)
    return lo, hi


def generate_modular_op(modulus: int, pol_input: list[int]) -> dict:
    """pol_input: 31 signed coefficient ints. Returns witness columns (all
    canonical non-negative field ints)."""
    assert len(pol_input) == 2 * N_LIMBS - 1
    value = signed_limbs_to_int(pol_input)
    output = value % modulus
    quot = (value - output) // modulus
    quot_sign = 1 if quot >= 0 else -1

    output_limbs = int_to_limbs(output, N_LIMBS)
    quot_abs_limbs = int_to_limbs(abs(quot), N_LIMBS + 1)
    out_aux_red = int_to_limbs((1 << 256) - modulus + output, N_LIMBS)

    # constr(x) = input(x) - output(x) - quot(x) * m(x), 32 coeffs
    m_limbs = int_to_limbs(modulus, N_LIMBS)
    q_limbs = int_to_signed_limbs(quot, N_LIMBS + 1)
    constr = list(pol_input) + [0]
    for i in range(N_LIMBS):
        constr[i] -= output_limbs[i]
    for i in range(N_LIMBS + 1):
        for j in range(N_LIMBS):
            constr[i + j] -= q_limbs[i] * m_limbs[j]
    aux = _divide_by_x_minus_beta(constr)  # 31 coeffs
    lo, hi = _aux_split(aux)

    return {
        "output": output_limbs,
        "quot_sign": 1 if quot_sign == 1 else gl.P - 1,
        "out_aux_red": out_aux_red,
        "quot_abs": quot_abs_limbs,
        "aux_lo": lo,
        "aux_hi": hi,
        "output_int": output,
    }


def generate_modular_zero(modulus: int, pol_input: list[int]) -> dict:
    """Same trick specialized to input === 0 mod m (no output columns);
    reference src/modular/modular_zero.rs:33-80."""
    assert len(pol_input) == 2 * N_LIMBS - 1
    value = signed_limbs_to_int(pol_input)
    assert value % modulus == 0, "modular-zero witness: input not divisible"
    quot = value // modulus
    quot_sign = 1 if quot >= 0 else -1

    quot_abs_limbs = int_to_limbs(abs(quot), N_LIMBS + 1)
    m_limbs = int_to_limbs(modulus, N_LIMBS)
    q_limbs = int_to_signed_limbs(quot, N_LIMBS + 1)
    constr = list(pol_input) + [0]
    for i in range(N_LIMBS + 1):
        for j in range(N_LIMBS):
            constr[i + j] -= q_limbs[i] * m_limbs[j]
    aux = _divide_by_x_minus_beta(constr)
    lo, hi = _aux_split(aux)
    return {
        "quot_sign": 1 if quot_sign == 1 else gl.P - 1,
        "quot_abs": quot_abs_limbs,
        "aux_lo": lo,
        "aux_hi": hi,
    }


def zero_modular_aux() -> dict:
    """Filler witness for filtered-off rows (filter = 0): all-zero aux with
    quot_sign = 1, matching FqOutput::default (reference fq/mul.rs:24-32)."""
    return {
        "output": [0] * N_LIMBS,
        "quot_sign": 1,
        "out_aux_red": [0] * N_LIMBS,
        "quot_abs": [0] * (N_LIMBS + 1),
        "aux_lo": [0] * (2 * N_LIMBS - 1),
        "aux_hi": [0] * (2 * N_LIMBS - 1),
        "output_int": 0,
    }


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
