"""BN254 constants used by the ported AIRs (host Python ints).

A host copy of the JAX package's bn254.py constants; only the values the
ported statements need live here, and each is the same integer.
"""

# BN254 base field modulus
P_BN = 21888242871839275222246405745257275088696311157297823662689037894645226208583
