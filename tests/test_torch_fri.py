"""The port's transcript, FRI (with the proof-of-work grind of kernel K3)
and STARK engine pieces against the JAX package, on the same numpy inputs,
on the CPU. Tolerance: exact equality (all arithmetic is exact mod p).
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starky_bn254_tpu import merkle as jmerkle
from starky_bn254_tpu.challenger import Challenger as JaxChallenger
from starky_bn254_tpu.stark import fri as jfri
from starky_bn254_tpu.stark import prover as jprover
from starky_bn254_tpu.stark.config import FriConfig as JaxFriConfig
from starky_bn254_tpu_torch import goldilocks as gl
from starky_bn254_tpu_torch import merkle, ntt, xnp
from starky_bn254_tpu_torch.challenger import Challenger
from starky_bn254_tpu_torch.stark import fri, prover
from starky_bn254_tpu_torch.stark.config import FriConfig

P = gl.P

# one intra-op thread: test files run side by side in parallel workers, and
# torch's thread pool oversubscribes the cores (small ops get slower, not faster)
torch.set_num_threads(1)


def _field(seed, shape):
    return np.random.default_rng(seed).integers(0, P, shape, dtype=np.uint64)


def test_challenger_transcript_pinned():
    c = Challenger()
    c.observe_elements(list(range(7)))
    c.observe_elements(np.arange(1000, dtype=np.uint64))  # vector-digest path
    got = np.array(c.get_n_challenges(4), dtype=np.uint64)
    assert hashlib.sha256(got.tobytes()).hexdigest()[:16] == "66748d59e7863dfb"


def test_challenger_matches_jax_on_mixed_sequence():
    """Elements, long vectors (tree digest), Keccak-style caps with words
    >= p (reduced mod p before observing) and interleaved squeezes."""
    rng = np.random.default_rng(3)
    cap = rng.integers(0, 1 << 64, (16, 4), dtype=np.uint64)
    cap[0, 0] = np.uint64((1 << 64) - 1)
    ops = [("e", 5), ("v", _field(4, 300)), ("s", 3), ("cap", cap), ("v", _field(5, 127)),
           ("ext", None), ("v", _field(6, 129)), ("idx", 1024)]
    ours, ref = Challenger(), JaxChallenger()
    for kind, arg in ops:
        if kind == "e":
            ours.observe_element(arg)
            ref.observe_element(arg)
        elif kind == "v":
            ours.observe_elements(arg)
            ref.observe_elements(arg)
        elif kind == "cap":
            ours.observe_cap(arg)
            ref.observe_cap(arg)
        elif kind == "s":
            assert ours.get_n_challenges(arg) == ref.get_n_challenges(arg)
        elif kind == "ext":
            assert ours.get_ext_challenge() == ref.get_ext_challenge()
        else:
            assert ours.get_indices(12, arg) == ref.get_indices(12, arg)


@pytest.mark.parametrize("seed,bits", [(0x1234_5678_9ABC_DEF0 % P, 4),
                                       (987654321987, 6), (31337 << 30, 8)],
                         ids=["b4", "b6", "b8"])
def test_grind_nonce_matches_jax(seed, bits):
    nonce = fri.grind(seed, bits, "cpu")
    assert nonce == jfri.grind(seed, bits)
    assert fri.check_pow(seed, nonce, bits) and jfri.check_pow(seed, nonce, bits)
    assert fri.check_pow(seed, nonce + 1, bits) == jfri.check_pow(seed, nonce + 1, bits)


def test_fold_step_matches_jax():
    values = _field(7, (256, 2))
    beta = (12345, 67890)
    w_m_inv = pow(gl.primitive_root_of_unity(8), P - 2, P)
    s_inv = pow(7, P - 2, P)
    want = jfri._fold_step4(jnp.asarray(values), jnp.asarray(np.array(beta, dtype=np.uint64)),
                            jnp.asarray(np.uint64(w_m_inv)), jnp.asarray(np.uint64(s_inv)))
    got = fri._fold_step4(xnp.to_torch(values), beta, w_m_inv, s_inv)
    assert (xnp.to_numpy(got) == np.asarray(want)).all()


@pytest.mark.parametrize("hasher", ["poseidon", "keccak"])
def test_fri_prove_matches_jax_and_verifies(hasher):
    """fri_prove over the same oracles and transcript state in both
    packages: identical layer caps, final polynomial, nonce and query
    openings; the port's query-layer check accepts them."""
    kw = dict(rate_bits=1, cap_height=1, proof_of_work_bits=4, num_query_rounds=6,
              final_poly_bits=2, merkle_hash=hasher)
    cfg, jcfg = FriConfig(**kw), JaxFriConfig(**kw)
    n = 1 << 9
    # F of degree < n / blowup on the coset 7 * H_n, as the prover builds it
    f_values = xnp.to_numpy(ntt.lde_from_coeffs(xnp.to_torch(_field(8, (n // 2, 2))), 1, 7))
    mat = _field(9, (n, 5))
    tree = merkle.build_merkle_tree(xnp.to_torch(mat), 1, hasher)
    jtree = jmerkle.build_merkle_tree(jnp.asarray(mat), 1, hasher)
    ours, ref = Challenger(), JaxChallenger()
    for c in (ours, ref):
        c.observe_elements(np.arange(9, dtype=np.uint64))
    proof = fri.fri_prove(xnp.to_torch(f_values), 7, [(tree, xnp.to_torch(mat))], ours, cfg)
    jproof = jfri.fri_prove(jnp.asarray(f_values), 7, [(jtree, jnp.asarray(mat))], ref, jcfg)
    assert proof.pow_nonce == jproof.pow_nonce
    assert (proof.final_coeffs == jproof.final_coeffs).all()
    assert len(proof.layer_caps) == len(jproof.layer_caps)
    for a, b in zip(proof.layer_caps, jproof.layer_caps):
        assert (a == b).all()
    for q, jq in zip(proof.query_rounds, jproof.query_rounds):
        for group, jgroup in ((q.initial_leaves, jq.initial_leaves),
                              (q.initial_paths, jq.initial_paths),
                              (q.layer_leaves, jq.layer_leaves),
                              (q.layer_paths, jq.layer_paths)):
            assert all((a == np.asarray(b)).all() for a, b in zip(group, jgroup))

    # replay the transcript as the verifier does, then check the queries
    v = Challenger()
    v.observe_elements(np.arange(9, dtype=np.uint64))
    betas = []
    for cap in proof.layer_caps:
        v.observe_cap(cap)
        betas.append(v.get_ext_challenge())
    v.observe_elements(proof.final_coeffs.reshape(-1))
    v.get_challenge()
    v.observe_element(proof.pow_nonce)
    idx = np.array(v.get_indices(cfg.num_query_rounds, n), dtype=np.int64)
    f_at = f_values[idx]
    layers = range(len(proof.layer_caps))
    leaves = [np.stack([q.layer_leaves[k] for q in proof.query_rounds]) for k in layers]
    paths = [np.stack([q.layer_paths[k] for q in proof.query_rounds]) for k in layers]
    args = (idx, leaves, paths, proof.layer_caps, betas, proof.final_coeffs, n, 7, cfg)
    with np.errstate(over="ignore"):
        assert fri.fri_verify_query_layers(f_at, *args)
        bad = f_at.copy()
        bad[0, 0] ^= np.uint64(1)
        assert not fri.fri_verify_query_layers(bad, *args)


def test_lde_selectors_match_jax():
    ours, ref = prover._lde_selectors(64, 1), jprover._lde_selectors(64, 1)
    for k in ("xs", "zh", "zh_inv", "l_first", "l_last", "z_last"):
        assert (np.asarray(ours[k]) == ref[k]).all(), k
    assert ours["g_last"] == ref["g_last"]


def test_z_columns_match_jax():
    trace = np.random.default_rng(10).integers(0, 256, (128, 6), dtype=np.uint64)
    pairs = [(0, 1), (2, 3), (4, 5), (1, 4)]
    gammas = [int(v) for v in _field(11, 2)]
    want = np.asarray(jprover.compute_z_columns(jnp.asarray(trace), pairs, gammas))
    got = prover.compute_z_columns(xnp.to_torch(trace), pairs, gammas)
    assert (xnp.to_numpy(got) == want).all()


def test_composition_row_blocks_agree():
    """The quotient values do not depend on the row-block height (blocks
    wrap cyclically for the next-row view)."""
    from starky_bn254_tpu_torch import bn254
    from starky_bn254_tpu_torch.airs.fq_mul import FqMulAir
    from starky_bn254_tpu_torch.stark import StarkConfig
    from starky_bn254_tpu_torch.stark.composition import evaluate_composition

    air = FqMulAir(256)
    rng = np.random.default_rng(12)
    inputs = [(int(rng.integers(0, 1 << 62)) % bn254.P_BN,
               int(rng.integers(0, 1 << 62)) % bn254.P_BN) for _ in range(40)]
    trace = xnp.to_torch(air.generate_trace(inputs))
    cfg = StarkConfig.test_config()
    lde = ntt.coset_lde(trace, cfg.fri.rate_bits)
    z = prover.compute_z_columns(trace, air.permutation_pairs(), [5, 9])
    z_lde = ntt.coset_lde(z, cfg.fri.rate_bits)
    args = (air, lde, z_lde, np.zeros(0, dtype=np.uint64), [3, 4], [5, 9], 256, cfg)
    whole = evaluate_composition(*args, block_rows=512)
    blocked = evaluate_composition(*args, block_rows=128)
    assert torch.equal(whole, blocked)
