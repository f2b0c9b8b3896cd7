"""Registry of vector-commitment (Merkle) hashers, selected by
`FriConfig.merkle_hash`.

A hasher module exposes: WIDTH (state words), RATE (absorbed words per
permutation), hash_no_pad, hash_or_noop, sponge_absorb, finalize, compress.
Digests are [..., 4] u64 words everywhere; the challenger reduces digest
words mod p when observing caps (identity for Poseidon's canonical outputs).
"""

from __future__ import annotations


def get_hasher(name: str):
    if name == "poseidon":
        from . import poseidon

        return poseidon
    if name == "keccak":
        from . import keccak

        return keccak
    raise ValueError(f"unknown merkle hash {name!r}")
