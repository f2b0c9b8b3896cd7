"""The port's slice end to end on the CPU: FqMulAir proved by
starky_bn254_tpu_torch through its plain torch paths, held byte for byte
against the JAX package (the checked-in fixture, the pinned seed-7 digest,
and a live JAX prove under the keccak Merkle hash), with each package's
verifier accepting the other's proofs. All arithmetic is exact mod p, so
every comparison is exact equality.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from starky_bn254_tpu.airs.fq_mul import FqMulAir as JaxFqMulAir
from starky_bn254_tpu.stark import StarkConfig as JaxStarkConfig
from starky_bn254_tpu.stark import VerificationError as JaxVerificationError
from starky_bn254_tpu.stark import prove as jax_prove
from starky_bn254_tpu.stark import verify as jax_verify
from starky_bn254_tpu.stark.config import FriConfig as JaxFriConfig
from starky_bn254_tpu.stark.proof import proof_from_bytes as jax_proof_from_bytes
from starky_bn254_tpu.stark.proof import proof_to_bytes as jax_proof_to_bytes
from starky_bn254_tpu_torch import bn254, xnp
from starky_bn254_tpu_torch.airs.fq_mul import FqMulAir
from starky_bn254_tpu_torch.stark import (
    FriConfig,
    StarkConfig,
    VerificationError,
    load_proof,
    proof_from_bytes,
    proof_to_bytes,
    prove,
    verify,
)
from starky_bn254_tpu_torch.stark.proof import proof_digest

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "fq_mul_256_test_config.npz")
SEED7_DIGEST = "10cb158ab61caf68"  # tests/test_determinism.py
# test_config fields with merkle_hash="keccak", FqMulAir(256), seed 42 /
# 250 inputs (the fixture's statement); chip_smoke.py checks it on the card
KECCAK_DIGEST = "d9399851e8b42e5a"

# one intra-op thread: test files run side by side in parallel workers, and
# torch's thread pool oversubscribes the cores (small ops get slower, not faster)
torch.set_num_threads(1)


def fq_inputs(seed: int, count: int):
    rng = np.random.default_rng(seed)
    return [
        (int.from_bytes(rng.bytes(40), "little") % bn254.P_BN,
         int.from_bytes(rng.bytes(40), "little") % bn254.P_BN)
        for _ in range(count)
    ]


def keccak_test_config(fri_cls, stark_cls):
    base = StarkConfig.test_config().fri
    return stark_cls(num_challenges=2, fri=fri_cls(
        rate_bits=base.rate_bits, cap_height=base.cap_height,
        proof_of_work_bits=base.proof_of_work_bits,
        num_query_rounds=base.num_query_rounds,
        final_poly_bits=base.final_poly_bits, merkle_hash="keccak",
    ))


@pytest.fixture(scope="module")
def trace42():
    return FqMulAir(256).generate_trace(fq_inputs(42, 250))


@pytest.fixture(scope="module")
def port_proof42(trace42):
    # the numpy trace as the JAX prove takes it; the CPU named explicitly
    return prove(FqMulAir(256), trace42, np.zeros(0, dtype=np.uint64),
                 StarkConfig.test_config(), device="cpu")


def test_trace_matches_jax(trace42):
    assert (JaxFqMulAir(256).generate_trace(fq_inputs(42, 250)) == trace42).all()


def test_port_proof_is_fixture_bytes(port_proof42):
    assert proof_to_bytes(port_proof42) == proof_to_bytes(load_proof(FIXTURE))


def test_prove_leaves_the_numpy_trace_unchanged(trace42, port_proof42):
    """prove(..., device="cpu") took the numpy trace (port_proof42, the
    fixture's bytes above) without writing into it."""
    assert (trace42 == FqMulAir(256).generate_trace(fq_inputs(42, 250))).all()


def test_prove_without_card_raises(trace42, monkeypatch):
    """With no device named, prove runs on the card, and where there is
    none it raises and names the missing card instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        prove(FqMulAir(256), trace42, np.zeros(0, dtype=np.uint64), StarkConfig.test_config())
    with pytest.raises(RuntimeError, match="no CUDA card"):
        prove(FqMulAir(256), xnp.to_torch(trace42), np.zeros(0, dtype=np.uint64),
              StarkConfig.test_config())


def test_prove_rejects_a_trace_of_another_dtype(trace42):
    with pytest.raises(TypeError, match="int64"):
        prove(FqMulAir(256), torch.zeros((256, 4), dtype=torch.int32),
              np.zeros(0, dtype=np.uint64), StarkConfig.test_config(), device="cpu")


def test_seed7_digest_pinned():
    air = FqMulAir(256)
    trace = air.generate_trace(fq_inputs(7, 64))
    proof = prove(air, xnp.to_torch(trace), np.zeros(0, dtype=np.uint64),
                  StarkConfig.test_config(), device="cpu")
    assert proof_digest(proof) == SEED7_DIGEST


def test_jax_verifier_accepts_port_proof(port_proof42):
    jproof = jax_proof_from_bytes(proof_to_bytes(port_proof42))
    assert jax_verify(JaxFqMulAir(256), jproof, JaxStarkConfig.test_config())


def test_port_verifier_accepts_fixture():
    assert verify(FqMulAir(256), load_proof(FIXTURE), StarkConfig.test_config())


def _tamper_opening(p):
    p.openings.trace_zeta[3, 0] ^= np.uint64(1)


def _tamper_nonce(p):
    p.fri.pow_nonce += 1


def _tamper_leaf(p):
    p.fri.query_rounds[0].initial_leaves[0][5] ^= np.uint64(1)


@pytest.mark.parametrize("tamper", [_tamper_opening, _tamper_nonce, _tamper_leaf],
                         ids=["opening", "pow_nonce", "query_leaf"])
def test_tampered_proof_rejected(port_proof42, tamper):
    proof = proof_from_bytes(proof_to_bytes(port_proof42))
    tamper(proof)
    with pytest.raises(VerificationError):
        verify(FqMulAir(256), proof, StarkConfig.test_config())
    with pytest.raises(JaxVerificationError):
        jax_verify(JaxFqMulAir(256), jax_proof_from_bytes(proof_to_bytes(proof)),
                   JaxStarkConfig.test_config())


def test_keccak_variant_matches_jax(trace42):
    cfg = keccak_test_config(FriConfig, StarkConfig)
    jcfg = keccak_test_config(JaxFriConfig, JaxStarkConfig)
    pi = np.zeros(0, dtype=np.uint64)
    port = prove(FqMulAir(256), xnp.to_torch(trace42), pi, cfg, device="cpu")
    ref = jax_prove(JaxFqMulAir(256), jnp.asarray(trace42), pi, jcfg)
    assert proof_to_bytes(port) == jax_proof_to_bytes(ref)
    assert proof_digest(port) == KECCAK_DIGEST
    assert verify(FqMulAir(256), proof_from_bytes(jax_proof_to_bytes(ref)), cfg)
