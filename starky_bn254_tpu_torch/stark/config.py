"""STARK / FRI configuration.

Mirrors the knobs of the reference's `StarkConfig::standard_fast_config`
(reference src/fields/fq/exp.rs:210-213 calls it with dynamic column counts;
the underlying fork crate fixes rate_bits/queries) without copying its layout:
here the config is explicit and carried through prover and verifier.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class FriConfig:
    rate_bits: int = 1  # blowup = 2^rate_bits
    cap_height: int = 4
    proof_of_work_bits: int = 16
    num_query_rounds: int = 84
    # stop folding when the layer's polynomial degree is <= 2^final_poly_bits
    # (slightly larger final polys trade a few KB of proof for fewer fold
    # layers and Merkle paths)
    final_poly_bits: int = 7
    # Vector-commitment (Merkle) hash: "poseidon" (width 12, rate 8 — the
    # reference's PoseidonGoldilocksConfig shape) or "keccak" (Keccak-f[1600],
    # rate 17 — plonky2's KeccakGoldilocksConfig alternative). The
    # Fiat-Shamir challenger and FRI proof-of-work use Poseidon in EVERY
    # mode, so this knob never touches the transcript discipline.
    merkle_hash: str = "poseidon"
    # Transcript-parity mode (plonky2 discipline) of the JAX package: kept so
    # configs carry the same fields in both packages; the port's prove and
    # verify raise NotImplementedError when it is set.
    parity: bool = False

    @property
    def blowup(self) -> int:
        return 1 << self.rate_bits


@dataclass(frozen=True)
class StarkConfig:
    num_challenges: int = 2  # independent base-field challenge copies
    fri: FriConfig = field(default_factory=FriConfig)

    @staticmethod
    def standard_fast_config(merkle_hash: str = "poseidon") -> "StarkConfig":
        return StarkConfig(fri=FriConfig(merkle_hash=merkle_hash))

    @staticmethod
    def test_config() -> "StarkConfig":
        """Cheap config for unit tests (NOT sound at production level)."""
        return StarkConfig(
            num_challenges=2,
            fri=FriConfig(
                rate_bits=1,
                cap_height=1,
                proof_of_work_bits=4,
                num_query_rounds=12,
                final_poly_bits=3,
            ),
        )
