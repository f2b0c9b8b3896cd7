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
from .. import merkle, ntt, poseidon, xnp
from ..challenger import Challenger, _permute_host
from ..hashing import get_hasher
from ..utils import timing as tm
from .config import FriConfig
from .proof import FriProof, FriQueryRound

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


def fri_prove(
    f_values: torch.Tensor,  # [N, 2] extension values of F on shift * H_N
    shift: int,
    oracles: list[tuple[merkle.MerkleTree, torch.Tensor]],
    challenger: Challenger,
    cfg: FriConfig,
    timing=None,
    inject: dict | None = None,
    mesh=None,
) -> FriProof:
    """FRI over F on f_values' device. oracles: (tree, LDE) of every
    committed matrix, whose rows the queries open; an LDE may lie on the
    host (offloaded) or in row shards (parallel.sharded.RowShards), its
    tree on the device. inject: {layer size m: [m, 2] weighted extension
    values}: a mixed-height batch adds a smaller statement's opening
    polynomial into the running fold values when the ladder reaches its
    size (its oracles were committed on that layer's coset,
    stark/batch_prove.py), so the layer's commitment binds it. mesh: a
    parallel.sharded.Mesh; a layer of q = m/4 outputs with q a multiple of
    4 x its size folds row-sharded over it (sharded_fri_fold), the same
    values; every layer is committed on f_values' device. timing: a
    utils.timing recorder (None: timing.current(), inside a span "fri")."""
    with tm.entry(timing, "fri") as tt:
        return _fri_prove(f_values, shift, oracles, challenger, cfg, tt, inject, mesh)


def _fri_prove(f_values, shift, oracles, challenger, cfg: FriConfig, tt, inject, mesh) -> FriProof:
    n = f_values.shape[0]
    assert n & (n - 1) == 0
    dev = f_values.device
    inject = dict(inject) if inject else {}
    if any(m >= n for m in inject):
        raise ValueError(f"inject sizes {sorted(inject)} must be below the top size {n}")

    values = f_values
    cur_shift = shift
    m = n
    layer_trees: list[merkle.MerkleTree] = []
    layer_pairs: list[torch.Tensor] = []

    with tt.scope("commit/fold layers"):
        while m > (1 << cfg.final_poly_bits) * cfg.blowup:
            values = xnp.on_device(values, dev)  # a sharded fold leaves its rows on the shards
            if m in inject:
                values = gl.ext_add(values, inject.pop(m))
            q = m // ARITY
            pairs = torch.cat([values[k * q : (k + 1) * q] for k in range(ARITY)], dim=-1)
            cap_h = min(cfg.cap_height, q.bit_length() - 1)
            tree = merkle.build_merkle_tree(pairs, cap_h, cfg.merkle_hash)
            layer_trees.append(tree)
            layer_pairs.append(pairs)
            challenger.observe_cap(tree.cap)
            beta = challenger.get_ext_challenge()
            w_m_inv = pow(gl.primitive_root_of_unity(m.bit_length() - 1), gl.P - 2, gl.P)
            s_inv = pow(cur_shift, gl.P - 2, gl.P)
            if mesh is not None and q % (ARITY * mesh.size) == 0:
                from ..parallel.sharded import sharded_fri_fold

                values = sharded_fri_fold(mesh, values, beta, w_m_inv, s_inv)
            else:
                values = _fold_step4(values, beta, w_m_inv, s_inv)
            cur_shift = pow(cur_shift, ARITY, gl.P)
            m = q
    if inject:
        raise ValueError(f"inject sizes {sorted(inject)} are not layers of the fold ladder")

    # final polynomial: interpolate the remaining values (componentwise base
    # NTT is valid for extension values: the NTT matrix is base-field)
    with tt.scope("final poly"):
        values = xnp.on_device(values, dev)
        coeffs_shifted = ntt.ntt(values, inverse=True)  # [m, 2]
        s_inv = pow(cur_shift, gl.P - 2, gl.P)
        unscale = gl.powers_vec(np.array([s_inv], dtype=np.uint64), m)  # host
        final_len = m // cfg.blowup
        final_coeffs = gl.mul(coeffs_shifted, xnp.to_torch(unscale, dev)[:, None])[:final_len]
        final_np = xnp.to_numpy(final_coeffs)
        challenger.observe_elements(final_np.reshape(-1))

    with tt.scope("pow grind"):
        if cfg.parity:
            # plonky2 discipline: the nonce is observed, then the next
            # squeezed challenge must lie below 2^(64 - pow_bits)
            state, pending = challenger.snapshot()
            nonce = grind_parity(state, pending, cfg.proof_of_work_bits, dev)
            challenger.observe_element(nonce)
            response = challenger.get_challenge()
            assert response < (1 << (64 - cfg.proof_of_work_bits))
        else:
            pow_seed = challenger.get_challenge()
            nonce = grind(pow_seed, cfg.proof_of_work_bits, dev)
            challenger.observe_element(nonce)

    indices = challenger.get_indices(cfg.num_query_rounds, n)

    with tt.scope("query extraction"):
        idx_host = torch.tensor(indices, dtype=torch.int64)
        idx = idx_host.to(dev)
        # the queried rows of each oracle, gathered where it lies (an
        # offloaded LDE gives up its 84 rows on the host, and nothing more;
        # row shards each give up theirs)
        init_leaves = [xnp.to_numpy(xnp.take_rows(mat, idx_host % mat.shape[0]))
                       for _, mat in oracles]
        init_paths = [
            xnp.to_numpy(merkle.sibling_paths(idx % tree.levels[0].shape[0], tree.levels[:-1]))
            for tree, _ in oracles
        ]
        layer_leaves, layer_paths = [], []
        cur = idx
        for pairs, tree in zip(layer_pairs, layer_trees):
            j = cur % pairs.shape[0]
            layer_leaves.append(xnp.to_numpy(pairs[j]))
            layer_paths.append(xnp.to_numpy(merkle.sibling_paths(j, tree.levels[:-1])))
            cur = j
        query_rounds = [
            FriQueryRound(
                [lv[q] for lv in init_leaves],
                [pt[q] for pt in init_paths],
                [lv[q] for lv in layer_leaves],
                [pt[q] for pt in layer_paths],
            )
            for q in range(len(indices))
        ]

    return FriProof(
        layer_caps=[xnp.to_numpy(t.cap) for t in layer_trees],
        final_coeffs=final_np,
        pow_nonce=nonce,
        query_rounds=query_rounds,
    )


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


def _powers_host(base: int, n: int) -> np.ndarray:
    """[1, base, ..., base^(n-1)] mod p on the host."""
    with np.errstate(over="ignore"):  # uint64 scalar steps wrap on purpose
        return gl.powers_vec(np.uint64(base), n)


def _fold_step4(values: torch.Tensor, beta, w_m_inv: int, s_inv: int) -> torch.Tensor:
    q = values.shape[0] // ARITY
    return _fold_quads(*(values[k * q : (k + 1) * q] for k in range(ARITY)), beta, w_m_inv, s_inv,
                       q=q)


def _fold_quads(v0, v1, v2, v3, beta, w_m_inv: int, s_inv: int, j0: int = 0,
                q: int | None = None) -> torch.Tensor:
    """Fold outputs j0 .. j0 + len(v0) - 1 of a layer of q outputs (default
    len(v0)) from v_t = F(i^t x_j) at those j; x_j^{-1} = s^{-1} w_m^{-j},
    w_m^{-j} read from the layer's host-built table (one per layer size and
    device)."""
    a0, a1, a2, a3 = _dft4_terms(v0, v1, v2, v3)
    q = v0.shape[0] if q is None else q
    w_pows = xnp.device_table(("fri_w_inv_pows", w_m_inv, q), v0.device,
                              lambda: _powers_host(w_m_inv, q))
    inv_x = gl.mul(w_pows[j0 : j0 + v0.shape[0]], s_inv)
    beta_arr = xnp.as_tensor_like(np.array(beta, dtype=np.uint64), v0)
    return _fold4_combine(a0, a1, a2, a3, inv_x, beta_arr)


# ----------------------------------------------------------------------------
# Proof-of-work grinding
# ----------------------------------------------------------------------------


def grind(seed: int, pow_bits: int, device) -> int:
    """Find nonce with H(seed, nonce)[0] < 2^(64 - pow_bits): the lowest hit
    of the first batch that has one. The search starts at a transcript-
    derived offset (the verifier checks the absolute nonce)."""
    threshold = 1 << (64 - pow_bits)
    batch = 1 << max(pow_bits + 2, 10)
    start = (seed >> 24) & 0xFFFFFFFF
    while True:
        idx = poseidon.grind_batch(seed, start, batch, threshold, device)
        if idx < batch:
            return start + idx
        start += batch


def grind_parity(state: list[int], input_buffer: list[int], pow_bits: int, device) -> int:
    """plonky2-style grind: the lowest nonce such that observing it and
    squeezing gives a challenge below 2^(64 - pow_bits). Whether the duplex
    fires inside observe (the buffer reaches RATE) or at the squeeze, the
    response is permute(state with lanes [0, k) <- the pending inputs and
    lane k <- nonce)[RATE - 1], k = len(input_buffer). The search starts at
    0."""
    k = len(input_buffer)
    assert k < poseidon.RATE
    threshold = 1 << (64 - pow_bits)
    base = list(state)
    base[:k] = input_buffer
    batch = 1 << max(pow_bits + 2, 10)
    start = 0
    while True:
        idx = poseidon.grind_parity_batch(base, k, start, batch, threshold, device)
        if idx < batch:
            return start + idx
        start += batch


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
