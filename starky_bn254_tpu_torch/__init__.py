"""starky_bn254_tpu_torch — the STARK prover of starky_bn254_tpu, ported to
PyTorch with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

Field elements are canonical Goldilocks u64 words held in int64 tensors
(xnp.to_torch / xnp.to_numpy convert without changing a bit). `prove` runs
on the CUDA card unless the caller names another device (`device="cpu"`);
on a CUDA device the NTTs (csrc/ntt.cu), the Keccak
and Poseidon sponges (csrc/keccak.cu, csrc/poseidon.cu) and the
proof-of-work grind run as hand-written kernels, built with nvcc at first
use. On the CPU the same modules run their plain torch versions. Proofs are
byte-identical to the JAX package's and load in either package.

This package imports torch and numpy, never jax.
"""

from .xnp import to_numpy, to_torch

__all__ = ["to_numpy", "to_torch"]
__version__ = "0.1.0"
