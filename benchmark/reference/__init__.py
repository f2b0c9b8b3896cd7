"""The plain reference: a frozen copy of the port's host verifier
(frozen/) and exact BN254 arithmetic for the statements' outputs. Imports
neither JAX nor the JAX package nor anything of the port."""
