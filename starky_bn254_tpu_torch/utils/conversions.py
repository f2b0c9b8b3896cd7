"""Limb <-> integer conversions for BN254 values in Goldilocks columns.

A host copy of the JAX package's utils/conversions.py (the parts the ported
AIRs use): a BN254 Fq element is 16 Goldilocks cells of 16-bit limbs
(N_LIMBS/LIMB_BITS, reference src/constants.rs:1-2). Signed intermediate
limb vectors use Python ints on the host (the device never sees negative
values — the AIRs offset them, reference src/modular/modular.rs:77-89).
"""

from __future__ import annotations

LIMB_BITS = 16
N_LIMBS = 16


def int_to_limbs(x: int, n: int = N_LIMBS, bits: int = LIMB_BITS) -> list[int]:
    assert x >= 0
    mask = (1 << bits) - 1
    out = [(x >> (bits * i)) & mask for i in range(n)]
    assert x >> (bits * n) == 0, "value too large for limb count"
    return out


def signed_limbs_to_int(limbs, bits: int = LIMB_BITS) -> int:
    """Limbs may be negative Python ints (aux polynomials)."""
    return sum(int(v) << (bits * i) for i, v in enumerate(limbs))


def int_to_signed_limbs(x: int, n: int, bits: int = LIMB_BITS) -> list[int]:
    """Balanced representation of a signed integer: all limbs share the sign
    of x (matching reference src/utils/utils.rs:151-167 bigint_to_columns)."""
    neg = x < 0
    limbs = int_to_limbs(-x if neg else x, n, bits)
    if neg:
        limbs = [-v for v in limbs]
    return limbs
