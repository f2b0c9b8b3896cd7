"""Proof containers (+ serialization), host-side numpy arrays.

The same dataclasses, npz layout and canonical byte encoding as the JAX
package's stark/proof.py, so a proof written by either package loads in
the other and `proof_to_bytes` of the same proof is byte-identical.
"""

from __future__ import annotations

import hashlib
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


def save_proof(path: str, proof: StarkProof) -> None:
    flat: dict[str, np.ndarray] = {
        "degree_bits": np.array(proof.degree_bits),
        "trace_cap": proof.trace_cap,
        "quotient_cap": proof.quotient_cap,
        "openings/trace_zeta": proof.openings.trace_zeta,
        "openings/trace_gzeta": proof.openings.trace_gzeta,
        "openings/quotient_zeta": proof.openings.quotient_zeta,
        "fri/final_coeffs": proof.fri.final_coeffs,
        "fri/pow_nonce": np.array(proof.fri.pow_nonce, dtype=np.uint64),
        "public_inputs": proof.public_inputs,
        "fri/num_layers": np.array(len(proof.fri.layer_caps)),
        "fri/num_queries": np.array(len(proof.fri.query_rounds)),
    }
    if proof.z_cap is not None:
        flat["z_cap"] = proof.z_cap
        flat["openings/z_zeta"] = proof.openings.z_zeta
        flat["openings/z_gzeta"] = proof.openings.z_gzeta
    for k, cap in enumerate(proof.fri.layer_caps):
        flat[f"fri/layer_cap/{k}"] = cap
    for q, qr in enumerate(proof.fri.query_rounds):
        for o, (leaf, p) in enumerate(zip(qr.initial_leaves, qr.initial_paths)):
            flat[f"fri/q{q}/init_leaf/{o}"] = leaf
            flat[f"fri/q{q}/init_path/{o}"] = p
        for k, (leaf, p) in enumerate(zip(qr.layer_leaves, qr.layer_paths)):
            flat[f"fri/q{q}/layer_leaf/{k}"] = leaf
            flat[f"fri/q{q}/layer_path/{k}"] = p
    np.savez_compressed(path, **flat)


def load_proof(path: str) -> StarkProof:
    z = np.load(path)
    n_layers = int(z["fri/num_layers"])
    n_queries = int(z["fri/num_queries"])
    has_z = "z_cap" in z
    queries = []
    for q in range(n_queries):
        init_leaves, init_paths, layer_leaves, layer_paths = [], [], [], []
        o = 0
        while f"fri/q{q}/init_leaf/{o}" in z:
            init_leaves.append(z[f"fri/q{q}/init_leaf/{o}"])
            init_paths.append(z[f"fri/q{q}/init_path/{o}"])
            o += 1
        for k in range(n_layers):
            layer_leaves.append(z[f"fri/q{q}/layer_leaf/{k}"])
            layer_paths.append(z[f"fri/q{q}/layer_path/{k}"])
        queries.append(FriQueryRound(init_leaves, init_paths, layer_leaves, layer_paths))
    openings = StarkOpenings(
        trace_zeta=z["openings/trace_zeta"],
        trace_gzeta=z["openings/trace_gzeta"],
        z_zeta=z["openings/z_zeta"] if has_z else None,
        z_gzeta=z["openings/z_gzeta"] if has_z else None,
        quotient_zeta=z["openings/quotient_zeta"],
    )
    return StarkProof(
        degree_bits=int(z["degree_bits"]),
        trace_cap=z["trace_cap"],
        z_cap=z["z_cap"] if has_z else None,
        quotient_cap=z["quotient_cap"],
        openings=openings,
        fri=FriProof(
            layer_caps=[z[f"fri/layer_cap/{k}"] for k in range(n_layers)],
            final_coeffs=z["fri/final_coeffs"],
            pow_nonce=int(z["fri/pow_nonce"]),
            query_rounds=queries,
        ),
        public_inputs=z["public_inputs"],
    )


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


def _u32(x: int) -> bytes:
    return int(x).to_bytes(4, "little")


def _arr_bytes(a: np.ndarray) -> bytes:
    return np.ascontiguousarray(a, dtype="<u8").tobytes()


def proof_to_bytes(proof: StarkProof) -> bytes:
    has_z = proof.z_cap is not None
    qr0 = proof.fri.query_rounds[0] if proof.fri.query_rounds else None
    leaf_widths = [lv.shape[0] for lv in qr0.initial_leaves] if qr0 else []
    depths = [p.shape[0] for p in qr0.initial_paths] if qr0 else []
    layer_depths = [p.shape[0] for p in qr0.layer_paths] if qr0 else [0] * len(
        proof.fri.layer_caps
    )
    out = [
        _MAGIC,
        _u32(1),
        _u32(proof.degree_bits),
        _u32(proof.openings.trace_zeta.shape[0]),
        _u32(1 if has_z else 0),
        _u32(proof.openings.z_zeta.shape[0] if has_z else 0),
        _u32(proof.openings.quotient_zeta.shape[0]),
        _u32(proof.trace_cap.shape[0]),
        _u32(len(proof.fri.layer_caps)),
        _u32(len(proof.fri.query_rounds)),
        _u32(proof.fri.final_coeffs.shape[0]),
        _u32(proof.public_inputs.shape[0]),
        _u32(len(leaf_widths)),
    ]
    out += [_u32(w) for w in leaf_widths]
    out += [_u32(d) for d in depths]
    out += [_u32(d) for d in layer_depths]
    out += [_u32(cap.shape[0]) for cap in proof.fri.layer_caps]
    out.append(_arr_bytes(proof.trace_cap))
    if has_z:
        out.append(_arr_bytes(proof.z_cap))
    out.append(_arr_bytes(proof.quotient_cap))
    o = proof.openings
    out += [_arr_bytes(o.trace_zeta), _arr_bytes(o.trace_gzeta)]
    if has_z:
        out += [_arr_bytes(o.z_zeta), _arr_bytes(o.z_gzeta)]
    out.append(_arr_bytes(o.quotient_zeta))
    for cap in proof.fri.layer_caps:
        out.append(_arr_bytes(cap))
    for qr in proof.fri.query_rounds:
        for leaf, path in zip(qr.initial_leaves, qr.initial_paths):
            out += [_arr_bytes(leaf), _arr_bytes(path)]
        for leaf, path in zip(qr.layer_leaves, qr.layer_paths):
            out += [_arr_bytes(leaf), _arr_bytes(path)]
    out.append(_arr_bytes(proof.fri.final_coeffs))
    out.append(int(proof.fri.pow_nonce).to_bytes(8, "little"))
    out.append(_arr_bytes(proof.public_inputs))
    return b"".join(out)


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


def proof_digest(proof: StarkProof) -> str:
    """Canonical 16-hex-digit digest over every field of a StarkProof
    (order-stable; the same walk as the JAX package's golden-digest test)."""
    h = hashlib.sha256()
    h.update(int(proof.degree_bits).to_bytes(8, "little"))
    h.update(int(proof.fri.pow_nonce).to_bytes(8, "little"))

    def upd(arr):
        if arr is not None:
            h.update(np.ascontiguousarray(arr, dtype=np.uint64).tobytes())

    for a in (proof.trace_cap, proof.z_cap, proof.quotient_cap,
              proof.openings.trace_zeta, proof.openings.trace_gzeta,
              proof.openings.z_zeta, proof.openings.z_gzeta,
              proof.openings.quotient_zeta, proof.fri.final_coeffs,
              proof.public_inputs):
        upd(a)
    for cap in proof.fri.layer_caps:
        upd(cap)
    for q in proof.fri.query_rounds:
        for group in (q.initial_leaves, q.initial_paths, q.layer_leaves, q.layer_paths):
            for a in group:
                upd(a)
    return h.hexdigest()[:16]
