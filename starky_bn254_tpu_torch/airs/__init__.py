"""BN254 AIRs ported so far: Fq multiplication, Fq exponentiation, G1 and G2
scalar multiplication."""
