# Frozen copy of starky_bn254_tpu_torch/stark/fri.py at commit fb7d4c0,
# cut to what the verifier reaches: no tracegen, aux build, commitment,
# proof-of-work search or proof serialisation.
# Part of the benchmark's reference verifier: never edited to follow the port.
"""FRI low-degree proof: commit/fold phase, grinding, and query phase.

* The batched opening polynomial F lives as extension values [N, 2] on the
  shifted evaluation domain, on the prover's device; every fold is arity 4
  (x -> x^4, a 4-point inverse DFT per output).
* Every fold layer (including layer 0 = F itself) is Merkle-committed with
  quad leaves [F(x_j), F(i x_j), F(-x_j), F(-i x_j)] (natural-order slices
  j + k*m/4), so one query opens all four fold inputs.
* The proof-of-work grind runs batches of the fused Poseidon kernel on the
  prover's device: poseidon.grind_batch (H(seed, nonce)), or under the
  parity config poseidon.grind_parity_batch (plonky2's observe(nonce) ->
  squeeze, from the challenger's state).
* The verifier-side helpers run on the host (numpy for the fold algebra,
  CPU tensors for Merkle hashing).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import goldilocks as gl
from .. import poseidon, xnp
from ..challenger import _permute_host
from ..hashing import get_hasher
from .config import FriConfig

ARITY = 4
INV_ARITY = pow(ARITY, gl.P - 2, gl.P)
# primitive 4th root of unity (sqrt(-1) mod p)
I_UNIT = pow(gl.POWER_OF_TWO_GENERATOR, 1 << (gl.TWO_ADICITY - 2), gl.P)
assert I_UNIT * I_UNIT % gl.P == gl.P - 1


def _fold_layer_sizes(n: int, cfg: FriConfig) -> list[int]:
    """Domain sizes of committed layers down to the final one."""
    sizes = []
    m = n
    while m > (1 << cfg.final_poly_bits) * cfg.blowup:
        sizes.append(m)
        m //= ARITY
    return sizes


def _dft4_terms(v0, v1, v2, v3):
    """a_t = sum_k i^{-kt} v_k for the 4-point inverse DFT (i^{-1} = -i)."""
    i_c = np.uint64(I_UNIT)
    iv1 = gl.mul(v1, i_c)
    iv3 = gl.mul(v3, i_c)
    a0 = gl.add(gl.add(v0, v1), gl.add(v2, v3))
    a1 = gl.add(gl.sub(gl.sub(v0, iv1), v2), iv3)
    a2 = gl.sub(gl.add(v0, v2), gl.add(v1, v3))
    a3 = gl.sub(gl.sub(gl.add(v0, iv1), v2), iv3)
    return a0, a1, a2, a3


def _fold4_combine(a0, a1, a2, a3, inv_x, beta_arr):
    """(1/4) * (a0 + b x^-1 a1 + b^2 x^-2 a2 + b^3 x^-3 a3); inv_x: [q]."""
    beta2 = gl.ext_mul(beta_arr, beta_arr)
    beta3 = gl.ext_mul(beta2, beta_arr)
    inv_x2 = gl.mul(inv_x, inv_x)
    inv_x3 = gl.mul(inv_x2, inv_x)
    r = a0
    for a, ix, b in ((a1, inv_x, beta_arr), (a2, inv_x2, beta2), (a3, inv_x3, beta3)):
        term = gl.ext_mul(gl.mul(a, ix[:, None]), xnp.broadcast_to(b, a.shape))
        r = gl.ext_add(r, term)
    return gl.mul(r, np.uint64(INV_ARITY))


# ----------------------------------------------------------------------------
# Proof-of-work grinding
# ----------------------------------------------------------------------------


def check_pow(seed: int, nonce: int, pow_bits: int) -> bool:
    val = _permute_host([seed, nonce] + [0] * (poseidon.WIDTH - 2))[0]
    return val < (1 << (64 - pow_bits))


# ----------------------------------------------------------------------------
# Verifier-side batched helpers (host)
# ----------------------------------------------------------------------------


def verify_merkle_batch(leaves, indices, paths, cap, hasher: str = "poseidon") -> bool:
    h = get_hasher(hasher)
    digests = h.hash_or_noop(xnp.to_torch(leaves))  # [Q, 4]
    paths = xnp.to_torch(paths)
    idx = torch.as_tensor(np.asarray(indices, dtype=np.int64))
    for lvl in range(paths.shape[1]):
        sib = paths[:, lvl]
        bit = (idx & 1).bool()[:, None]
        digests = h.compress(torch.where(bit, sib, digests), torch.where(bit, digests, sib))
        idx = idx >> 1
    expected = xnp.to_torch(cap)[idx]
    return bool((digests == expected).all())


def fri_verify_query_layers(
    f_at_idx: np.ndarray,  # [Q, 2] recomputed F(x_i) per query
    indices: np.ndarray,  # [Q]
    layer_leaves: list[np.ndarray],  # per layer: [Q, 8]
    layer_paths: list[np.ndarray],  # per layer: [Q, depth_k, 4]
    layer_caps: list[np.ndarray],
    betas: list[tuple[int, int]],
    final_coeffs: np.ndarray,  # [final_len, 2]
    n: int,
    shift: int,
    cfg: FriConfig,
    inject: dict | None = None,
) -> bool:
    """Batched fold-consistency check across all queries (host numpy).
    inject: {layer size m: [Q, 2] weighted F_j values at idx mod m}, the
    verifier's side of fri_prove's injection: the value expected to enter
    the layer of size m gains the injected statement's share. A size that
    is no layer of the ladder fails the check."""
    ok = True
    idx = indices.astype(np.int64)
    expected = np.asarray(f_at_idx)
    m = n
    cur_shift = shift
    inject = dict(inject) if inject else {}
    for k, (leaves, paths, cap) in enumerate(zip(layer_leaves, layer_paths, layer_caps)):
        if m in inject:
            expected = gl.ext_add(expected, np.asarray(inject.pop(m)))
        leaves = np.asarray(leaves)
        q = m // ARITY
        j = idx % q
        slot = idx // q  # which of the 4 coset points the query hit
        ok &= verify_merkle_batch(leaves, j, paths, cap, cfg.merkle_hash)
        vs = [leaves[:, 2 * t : 2 * t + 2] for t in range(ARITY)]  # F(i^t x_j)
        mine = vs[0]
        for t in range(1, ARITY):
            mine = np.where((slot == t)[:, None], vs[t], mine)
        ok &= bool((mine == expected).all())
        w_m = gl.primitive_root_of_unity(m.bit_length() - 1)
        w_m_inv = pow(w_m, gl.P - 2, gl.P)
        s_inv = pow(cur_shift, gl.P - 2, gl.P)
        inv_x = gl.mul(_pow_per_query(w_m_inv, j, q), np.uint64(s_inv))
        beta = np.array(betas[k], dtype=np.uint64)
        a0, a1, a2, a3 = _dft4_terms(*vs)
        expected = _fold4_combine(a0, a1, a2, a3, inv_x, beta)
        idx = j
        m = q
        cur_shift = pow(cur_shift, ARITY, gl.P)

    ok &= not inject  # every injected share entered a committed layer

    # final polynomial evaluation at the query points (base-field points)
    w_m = gl.primitive_root_of_unity(m.bit_length() - 1)
    x = gl.mul(_pow_per_query(w_m, idx, m), np.uint64(cur_shift))  # [Q]
    fc = np.asarray(final_coeffs)
    acc = np.zeros((x.shape[0], 2), dtype=np.uint64)
    x_ext = gl.ext_from_base(x)
    for c in range(fc.shape[0] - 1, -1, -1):
        acc = gl.ext_mul(acc, x_ext)
        acc = gl.ext_add(acc, np.broadcast_to(fc[c], acc.shape))
    ok &= bool((acc == expected).all())
    return ok


def _pow_per_query(base: int, exps: np.ndarray, m: int) -> np.ndarray:
    """base^exps (mod p) for exps < m, by binary exponentiation (host)."""
    bits = max(m.bit_length() - 1, 1)
    result = np.ones(exps.shape, dtype=np.uint64)
    sq = base % gl.P
    for b in range(bits):
        bit_set = ((exps >> b) & 1) != 0
        result = np.where(bit_set, gl.mul(result, np.uint64(sq)), result)
        sq = sq * sq % gl.P
    return result
