# Frozen copy of starky_bn254_tpu_torch/stark/verifier.py at commit fb7d4c0.
# Part of the benchmark's reference verifier: never edited to follow the port.
"""STARK verifier: transcript replay, composition check at zeta, FRI checks.

Runs on the host whatever device produced the proof: the constraint
recheck at zeta replays the SAME `Air.eval` the prover ran over LDE rows,
on numpy extension scalars; query-phase Merkle hashing runs on CPU tensors
(the hashers' plain paths) and the fold algebra on numpy.
"""

from __future__ import annotations

import numpy as np

from .. import goldilocks as gl
from ..challenger import Challenger
from .air import Air
from .composition import evaluate_composition_at_zeta
from .config import StarkConfig
from .fri import (
    ARITY,
    _fold_layer_sizes,
    _pow_per_query,
    check_pow,
    fri_verify_query_layers,
    verify_merkle_batch,
)
from .logup import table_aux_width
from .proof import StarkProof
from .prover import QUOTIENT_CHUNKS


class VerificationError(Exception):
    pass


def _require(cond: bool, msg: str):
    if not cond:
        raise VerificationError(msg)


def _ext_int(pair) -> np.ndarray:
    return np.array(pair, dtype=np.uint64)


def verify(air: Air, proof: StarkProof, cfg: StarkConfig) -> bool:
    """Verify a STARK proof; raises VerificationError on any failed check."""
    # the numpy constraint replay wraps u64 on purpose (branchless reduction)
    with np.errstate(over="ignore"):
        return _verify_impl(air, proof, cfg)


def _check_shapes(air: Air, proof: StarkProof, cfg: StarkConfig) -> bool:
    """The openings' and public inputs' shapes; returns whether the AIR has
    an aux commitment."""
    nc = cfg.num_challenges
    pairs, tables, extra_w = air.permutation_pairs(), air.lookup_tables(), air.aux_extra_width()
    has_aux = bool(pairs or tables or extra_w)
    aux_width = nc * (len(pairs) + table_aux_width(tables) + extra_w)
    _require(proof.openings.trace_zeta.shape == (air.num_columns, 2), "trace openings shape")
    _require(
        proof.openings.quotient_zeta.shape == (nc * QUOTIENT_CHUNKS, 2),
        "quotient openings shape",
    )
    if has_aux:
        _require(proof.z_cap is not None, "missing z commitment")
        _require(proof.openings.z_zeta.shape == (aux_width, 2), "z openings shape")
    _require(proof.public_inputs.shape == (air.num_public_inputs,), "public inputs shape")
    return has_aux


def _replay_statement(challenger: Challenger, proof: StarkProof, has_aux: bool, nc: int):
    """One statement's transcript up to its openings (PI, trace cap,
    gammas, aux cap, alphas, quotient cap, zeta, openings): (gammas,
    alphas, zeta)."""
    challenger.observe_elements(proof.public_inputs)
    challenger.observe_cap(proof.trace_cap)
    gammas: list[int] = []
    if has_aux:
        gammas = challenger.get_n_challenges(nc)
        challenger.observe_cap(proof.z_cap)
    alphas = challenger.get_n_challenges(nc)
    challenger.observe_cap(proof.quotient_cap)
    zeta = challenger.get_ext_challenge()
    challenger.observe_elements(proof.openings.flat_elements())
    return gammas, alphas, zeta


def _replay_fri(challenger: Challenger, fri, n_lde: int, cfg: StarkConfig):
    """The FRI transcript: layer caps and their betas, the final
    polynomial, the proof of work, the query indices: (betas, indices)."""
    layer_sizes = _fold_layer_sizes(n_lde, cfg.fri)
    _require(len(fri.layer_caps) == len(layer_sizes), "fri layer count")
    fri_betas = []
    for cap in fri.layer_caps:
        challenger.observe_cap(cap)
        fri_betas.append(challenger.get_ext_challenge())
    final_domain = layer_sizes[-1] // ARITY if layer_sizes else n_lde
    _require(
        fri.final_coeffs.shape == (final_domain // cfg.fri.blowup, 2),
        "final poly length",
    )
    challenger.observe_elements(fri.final_coeffs.reshape(-1))
    if cfg.fri.parity:
        # plonky2 discipline: observe the nonce, squeeze the response,
        # bound it (fri.grind_parity)
        challenger.observe_element(fri.pow_nonce)
        response = challenger.get_challenge()
        _require(response < (1 << (64 - cfg.fri.proof_of_work_bits)), "proof of work")
    else:
        pow_seed = challenger.get_challenge()
        _require(
            check_pow(pow_seed, fri.pow_nonce, cfg.fri.proof_of_work_bits),
            "proof of work",
        )
        challenger.observe_element(fri.pow_nonce)
    indices = challenger.get_indices(cfg.fri.num_query_rounds, n_lde)
    _require(len(fri.query_rounds) == cfg.fri.num_query_rounds, "query count")
    return fri_betas, indices


def _check_composition(air: Air, proof: StarkProof, has_aux: bool, gammas, alphas, zeta,
                       cfg: StarkConfig, what: str = "") -> None:
    """The constraints at zeta against the quotient openings, over the
    statement's own subgroup of 2^degree_bits rows."""
    n = 1 << proof.degree_bits
    zeta_arr = _ext_int(zeta)
    w_n = gl.primitive_root_of_unity(proof.degree_bits)
    g_last = pow(w_n, n - 1, gl.P)

    zeta_n = gl.ext_pow_const(zeta_arr, n)
    one = np.array([1, 0], dtype=np.uint64)
    zh = gl.ext_sub(zeta_n, one)
    n_inv = pow(n, gl.P - 2, gl.P)
    z_last_v = gl.ext_sub(zeta_arr, _ext_int((g_last, 0)))
    l_first = gl.ext_mul(gl.mul(zh, np.uint64(n_inv)), gl.ext_inv(gl.ext_sub(zeta_arr, one)))
    l_last = gl.ext_mul(gl.mul(zh, np.uint64(g_last * n_inv % gl.P)), gl.ext_inv(z_last_v))

    acc_mat = evaluate_composition_at_zeta(
        air,
        proof.openings.trace_zeta,
        proof.openings.trace_gzeta,
        proof.openings.z_zeta if has_aux else None,
        proof.openings.z_gzeta if has_aux else None,
        proof.public_inputs,
        alphas,
        gammas,
        z_last_v,
        l_first,
        l_last,
        cfg,
    )  # [nc, 2]

    q_open = np.asarray(proof.openings.quotient_zeta)  # [nc*chunks, 2]
    for k in range(cfg.num_challenges):
        q_zeta = q_open[k * QUOTIENT_CHUNKS]
        for j in range(1, QUOTIENT_CHUNKS):
            zeta_nj = gl.ext_pow_const(zeta_arr, n * j)
            q_zeta = gl.ext_add(q_zeta, gl.ext_mul(zeta_nj, q_open[k * QUOTIENT_CHUNKS + j]))
        _require(bool((acc_mat[k] == gl.ext_mul(zh, q_zeta)).all()),
                 f"composition mismatch ({what}alpha {k})")


def _check_initial_merkle(fri, caps, idx_np: np.ndarray, cfg: StarkConfig) -> None:
    """caps: (cap, LDE rows) per oracle, in the order the query rounds open
    them; each oracle is opened at idx mod its rows."""
    for o, (cap, n_lde_o) in enumerate(caps):
        leaves = np.stack([qr.initial_leaves[o] for qr in fri.query_rounds])
        paths = np.stack([qr.initial_paths[o] for qr in fri.query_rounds])
        _require(
            verify_merkle_batch(leaves, idx_np % n_lde_o, paths, cap, cfg.fri.merkle_hash),
            f"initial merkle check failed (oracle {o})",
        )


def _layer_openings(fri, n_layers: int):
    """Each fold layer's leaves and paths over the query rounds."""
    leaves = [np.stack([qr.layer_leaves[k] for qr in fri.query_rounds]) for k in range(n_layers)]
    paths = [np.stack([qr.layer_paths[k] for qr in fri.query_rounds]) for k in range(n_layers)]
    return leaves, paths


def _verify_impl(air: Air, proof: StarkProof, cfg: StarkConfig) -> bool:
    n_lde = (1 << proof.degree_bits) << cfg.fri.rate_bits
    has_aux = _check_shapes(air, proof, cfg)

    # ---- transcript replay -------------------------------------------------
    challenger = Challenger(parity=cfg.fri.parity)
    gammas, alphas, zeta = _replay_statement(challenger, proof, has_aux, cfg.num_challenges)
    beta = challenger.get_ext_challenge()
    fri_betas, indices = _replay_fri(challenger, proof.fri, n_lde, cfg)

    # ---- composition check at zeta ----------------------------------------
    _check_composition(air, proof, has_aux, gammas, alphas, zeta, cfg)

    # ---- FRI query checks (batched over queries) ---------------------------
    idx_np = np.array(indices, dtype=np.int64)
    caps = [proof.trace_cap] + ([proof.z_cap] if has_aux else []) + [proof.quotient_cap]
    _check_initial_merkle(proof.fri, [(cap, n_lde) for cap in caps], idx_np, cfg)

    f_at_idx = _recompute_f(proof, has_aux, idx_np, _ext_int(zeta), beta, n_lde)
    layer_leaves, layer_paths = _layer_openings(proof.fri, len(fri_betas))
    _require(
        fri_verify_query_layers(
            f_at_idx, idx_np, layer_leaves, layer_paths, proof.fri.layer_caps,
            fri_betas, proof.fri.final_coeffs, n_lde, gl.GENERATOR, cfg.fri,
        ),
        "fri fold/final-poly check failed",
    )
    return True


def _recompute_f(proof: StarkProof, has_aux: bool, idx: np.ndarray, zeta_arr: np.ndarray,
                 beta, n_lde: int, shift: int = gl.GENERATOR, initial_leaves=None) -> np.ndarray:
    """F(x_i) per query from the initial leaf rows (mirrors the prover's
    _batch_opening_poly), host numpy. initial_leaves: the statement's
    oracles' rows per query round, [round][oracle] (default: the proof's
    own)."""
    beta_arr = _ext_int(beta)
    w_big = gl.primitive_root_of_unity(n_lde.bit_length() - 1)
    xs = gl.mul(_pow_per_query(w_big, idx, n_lde), np.uint64(shift))
    x_ext = gl.ext_from_base(xs)  # [Q, 2]

    o_trace, o_z, o_q = 0, (1 if has_aux else None), (2 if has_aux else 1)

    rounds = initial_leaves or [qr.initial_leaves for qr in proof.fri.query_rounds]

    def leaves(o):
        return np.stack([r[o] for r in rounds])

    op = proof.openings
    zeta_rows = [leaves(o_trace)] + ([leaves(o_z)] if has_aux else []) + [leaves(o_q)]
    zeta_ys = [op.trace_zeta] + ([op.z_zeta] if has_aux else []) + [op.quotient_zeta]
    gzeta_rows = [leaves(o_trace)] + ([leaves(o_z)] if has_aux else [])
    gzeta_ys = [op.trace_gzeta] + ([op.z_gzeta] if has_aux else [])
    w_n = gl.primitive_root_of_unity(proof.degree_bits)
    gzeta_arr = gl.mul(zeta_arr, np.uint64(w_n))

    def group(rows, ys, point):
        total = sum(r.shape[1] for r in rows)
        w = gl.ext_powers_vec(beta_arr, total)
        s0 = s1 = None
        c_acc = np.zeros((2,), dtype=np.uint64)
        off = 0
        for r, y in zip(rows, ys):
            k = r.shape[1]
            wk = w[off : off + k]
            p0 = gl.sum_mod(gl.mul(r, wk[None, :, 0]), axis=1)  # [Q]
            p1 = gl.sum_mod(gl.mul(r, wk[None, :, 1]), axis=1)
            s0 = p0 if s0 is None else gl.add(s0, p0)
            s1 = p1 if s1 is None else gl.add(s1, p1)
            c_acc = gl.ext_add(c_acc, gl.sum_mod(gl.ext_mul(wk, np.asarray(y)), axis=0))
            off += k
        num = gl.ext_sub(np.stack([s0, s1], axis=-1), np.broadcast_to(c_acc, (s0.shape[0], 2)))
        den = gl.ext_sub(x_ext, np.broadcast_to(point, x_ext.shape))
        return gl.ext_mul(num, gl.ext_inv(den)), total

    g0, k0 = group(zeta_rows, zeta_ys, zeta_arr)
    g1, _ = group(gzeta_rows, gzeta_ys, gzeta_arr)
    beta_k0 = gl.ext_pow_const(beta_arr, k0)
    return gl.ext_add(g0, gl.ext_mul(g1, np.broadcast_to(beta_k0, g1.shape)))
