"""Batch composition: offset chaining for MSM / multi-exponentiation."""

from .msm import (
    Fq12MultiExp,
    G1Msm,
    G2Msm,
    g2_mul_by_cofactor_input,
    pad_instances,
    prove_fq12_multiexp,
    prove_fq_multiexp,
    prove_g1_msm,
    prove_g2_msm,
    prove_hash_to_g2,
    verify_fq12_multiexp,
    verify_fq_multiexp,
    verify_g1_msm,
    verify_g2_msm,
    verify_hash_to_g2,
)

__all__ = [
    "G1Msm",
    "G2Msm",
    "Fq12MultiExp",
    "g2_mul_by_cofactor_input",
    "pad_instances",
    "prove_g1_msm",
    "verify_g1_msm",
    "prove_g2_msm",
    "verify_g2_msm",
    "prove_fq12_multiexp",
    "verify_fq12_multiexp",
    "prove_fq_multiexp",
    "verify_fq_multiexp",
    "prove_hash_to_g2",
    "verify_hash_to_g2",
]
