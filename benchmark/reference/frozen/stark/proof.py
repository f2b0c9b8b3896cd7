# Frozen copy of starky_bn254_tpu_torch/stark/proof.py at commit fb7d4c0,
# cut to what the verifier reaches: no tracegen, aux build, commitment,
# proof-of-work search or proof serialisation.
# Part of the benchmark's reference verifier: never edited to follow the port.
"""Proof containers, host-side numpy arrays, and the reader of the
canonical byte encoding (`proof_from_bytes`) that the port's
`proof_to_bytes` writes.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class FriQueryRound:
    initial_leaves: list[np.ndarray]  # per oracle: committed row [width]
    initial_paths: list[np.ndarray]  # per oracle: [depth, 4]
    layer_leaves: list[np.ndarray]  # per fold layer: [8] = 4 ext values (arity 4)
    layer_paths: list[np.ndarray]  # per fold layer: [depth_k, 4]


@dataclass
class FriProof:
    layer_caps: list[np.ndarray]  # per fold layer: [2^cap, 4]
    final_coeffs: np.ndarray  # [final_len, 2] extension coefficients
    pow_nonce: int
    query_rounds: list[FriQueryRound] = field(default_factory=list)


@dataclass
class StarkOpenings:
    trace_zeta: np.ndarray  # [C, 2]
    trace_gzeta: np.ndarray  # [C, 2]
    z_zeta: np.ndarray | None  # [nZ, 2]
    z_gzeta: np.ndarray | None
    quotient_zeta: np.ndarray  # [num_challenges * chunks, 2]

    def flat_elements(self) -> np.ndarray:
        parts = [self.trace_zeta, self.trace_gzeta]
        if self.z_zeta is not None:
            parts += [self.z_zeta, self.z_gzeta]
        parts.append(self.quotient_zeta)
        return np.concatenate([p.reshape(-1) for p in parts])


@dataclass
class StarkProof:
    degree_bits: int
    trace_cap: np.ndarray  # [2^cap, 4]
    z_cap: np.ndarray | None
    quotient_cap: np.ndarray
    openings: StarkOpenings
    fri: FriProof
    public_inputs: np.ndarray  # [P] u64


# ---------------------------------------------------------------------------
# Canonical byte encoding (transcript-parity obligation)
# ---------------------------------------------------------------------------
#
# A stable, self-describing little-endian layout so proofs are a byte-level
# artifact, diffable across machines and implementations (the reference fork
# keeps proofs in-memory only; its serialization hooks are `todo!()` —
# reference src/fields/fq/circuit.rs:155-160). Field elements are canonical
# u64 < p, written little-endian in the same order plonky2's buffer
# serialization walks a StarkProof: caps, openings, FRI (layer caps, query
# rounds, final poly, pow witness), then public inputs.
#
#   header:  magic "SBTP" | u32 version=1 | u32 degree_bits
#            u32 num_columns(trace) | u32 has_z | u32 aux_width
#            u32 nq(quotient openings) | u32 cap_len | u32 n_layers
#            u32 n_queries | u32 final_len | u32 num_public_inputs
#            per-query structural widths are derivable from the above plus
#            the per-oracle widths table that follows:
#            u32 n_oracles | n_oracles * u32 leaf_width | n_oracles * u32 depth
#            n_layers * u32 layer_depth | n_layers * u32 layer_cap_len
#   body:    trace_cap [cap_len, 4] | z_cap? | quotient_cap
#            openings (trace_zeta, trace_gzeta, z_zeta?, z_gzeta?, quotient_zeta)
#            fri layer caps | per query (init leaves+paths, layer leaves+paths)
#            final_coeffs | pow_nonce u64 | public_inputs

_MAGIC = b"SBTP"


def proof_from_bytes(data: bytes) -> StarkProof:
    assert data[:4] == _MAGIC, "bad magic"
    pos = 4

    def u32():
        nonlocal pos
        v = int.from_bytes(data[pos : pos + 4], "little")
        pos += 4
        return v

    version = u32()
    assert version == 1, version
    degree_bits = u32()
    n_cols = u32()
    has_z = bool(u32())
    aux_w = u32()
    nq = u32()
    cap_len = u32()
    n_layers = u32()
    n_queries = u32()
    final_len = u32()
    n_pi = u32()
    n_oracles = u32()
    leaf_widths = [u32() for _ in range(n_oracles)]
    depths = [u32() for _ in range(n_oracles)]
    layer_depths = [u32() for _ in range(n_layers)]
    layer_cap_lens = [u32() for _ in range(n_layers)]

    def arr(shape):
        nonlocal pos
        count = int(np.prod(shape)) if shape else 1
        a = np.frombuffer(data, dtype="<u8", count=count, offset=pos).reshape(shape)
        pos += count * 8
        return a.astype(np.uint64)

    trace_cap = arr((cap_len, 4))
    z_cap = arr((cap_len, 4)) if has_z else None
    quotient_cap = arr((cap_len, 4))
    trace_zeta = arr((n_cols, 2))
    trace_gzeta = arr((n_cols, 2))
    z_zeta = arr((aux_w, 2)) if has_z else None
    z_gzeta = arr((aux_w, 2)) if has_z else None
    quotient_zeta = arr((nq, 2))
    layer_caps = [arr((c, 4)) for c in layer_cap_lens]
    queries = []
    for _ in range(n_queries):
        init_leaves = []
        init_paths = []
        for w, d in zip(leaf_widths, depths):
            init_leaves.append(arr((w,)))
            init_paths.append(arr((d, 4)))
        layer_leaves = []
        layer_paths = []
        for d in layer_depths:
            layer_leaves.append(arr((8,)))
            layer_paths.append(arr((d, 4)))
        queries.append(FriQueryRound(init_leaves, init_paths, layer_leaves, layer_paths))
    final_coeffs = arr((final_len, 2))
    pow_nonce = int.from_bytes(data[pos : pos + 8], "little")
    pos += 8
    public_inputs = arr((n_pi,))
    assert pos == len(data), (pos, len(data))
    return StarkProof(
        degree_bits=degree_bits,
        trace_cap=trace_cap,
        z_cap=z_cap,
        quotient_cap=quotient_cap,
        openings=StarkOpenings(trace_zeta, trace_gzeta, z_zeta, z_gzeta, quotient_zeta),
        fri=FriProof(layer_caps, final_coeffs, pow_nonce, queries),
        public_inputs=public_inputs,
    )

