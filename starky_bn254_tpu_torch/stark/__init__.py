"""Generic STARK engine: AIR interface, prover, verifier, FRI, config."""

from .air import Air
from .config import FriConfig, StarkConfig
from .proof import StarkProof, load_proof, proof_from_bytes, proof_to_bytes, save_proof
from .pipeline import prove_pipelined
from .prover import prove
from .verifier import VerificationError, verify

__all__ = [
    "Air",
    "FriConfig",
    "StarkConfig",
    "StarkProof",
    "load_proof",
    "save_proof",
    "proof_to_bytes",
    "proof_from_bytes",
    "prove",
    "prove_pipelined",
    "verify",
    "VerificationError",
]
