"""Limb <-> integer conversions for BN254 values in Goldilocks columns.

A host copy of the JAX package's utils/conversions.py: a BN254 Fq element is
16 Goldilocks cells of 16-bit limbs (N_LIMBS/LIMB_BITS, reference
src/constants.rs:1-2); public IO uses 8 x u32 limbs (reference
src/utils/utils.rs:24-34). Signed intermediate limb vectors use Python ints
on the host (the device never sees negative values — the AIRs offset them,
reference src/modular/modular.rs:77-89).
"""

from __future__ import annotations

import numpy as np

LIMB_BITS = 16
N_LIMBS = 16
NUM_INPUT_LIMBS = 8  # u32 limbs for public IO
INPUT_LIMB_BITS = 32


def int_to_limbs(x: int, n: int = N_LIMBS, bits: int = LIMB_BITS) -> list[int]:
    assert x >= 0
    mask = (1 << bits) - 1
    out = [(x >> (bits * i)) & mask for i in range(n)]
    assert x >> (bits * n) == 0, "value too large for limb count"
    return out


def limbs_to_int(limbs, bits: int = LIMB_BITS) -> int:
    return sum(int(v) << (bits * i) for i, v in enumerate(limbs))


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


def fq_to_u32_limbs(x: int) -> list[int]:
    return int_to_limbs(x, NUM_INPUT_LIMBS, INPUT_LIMB_BITS)


def u32_limbs_to_int(limbs) -> int:
    return limbs_to_int(limbs, INPUT_LIMB_BITS)


def fq_to_limbs_array(xs: list[int]) -> np.ndarray:
    """[k] ints -> [k, N_LIMBS] uint64 canonical limb columns."""
    return np.array([int_to_limbs(x) for x in xs], dtype=np.uint64)
