"""BN254 AIRs ported so far: Fq multiplication."""
