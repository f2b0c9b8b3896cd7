"""G2 scalar multiplication at test size, end to end on the CPU:
G2ExpAir(1, range_check="logup", io_binding="rlc") under test_config (512
rows, 2312 trace columns), proved by starky_bn254_tpu_torch and held byte
for byte against a proof the JAX package made of the same inputs
(tests/fixtures/g2_exp_1_rlc_test_config.npz). Each package's verifier
accepts the other's proof; a tampered opening, and the proof of the trace
under public inputs whose x and offset are exchanged, are rejected by both.

No test here runs the JAX prover. The fixture is its output, made by

    python tests/test_torch_g2_e2e.py

which proves the statement and the exchanged one with the JAX package
(about 4 min on the CPU) and writes the fixture.
"""

import os
import sys

if __name__ == "__main__":  # run as a script: the repo on the path, JAX on the CPU
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from starky_bn254_tpu.airs.g2_exp import G2ExpAir as JaxG2ExpAir  # noqa: E402
from starky_bn254_tpu.stark import StarkConfig as JaxStarkConfig  # noqa: E402
from starky_bn254_tpu.stark import VerificationError as JaxVerificationError  # noqa: E402
from starky_bn254_tpu.stark import prove as jax_prove  # noqa: E402
from starky_bn254_tpu.stark import verify as jax_verify  # noqa: E402
from starky_bn254_tpu.stark.proof import proof_from_bytes as jax_proof_from_bytes  # noqa: E402
from starky_bn254_tpu.stark.proof import proof_to_bytes as jax_proof_to_bytes  # noqa: E402
from starky_bn254_tpu_torch import bn254, xnp  # noqa: E402
from starky_bn254_tpu_torch.airs.g2_exp import G2ExpAir  # noqa: E402
from starky_bn254_tpu_torch.stark import (  # noqa: E402
    StarkConfig,
    VerificationError,
    proof_from_bytes,
    proof_to_bytes,
    prove,
    verify,
)
from starky_bn254_tpu_torch.utils.conversions import fq_to_u32_limbs  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "g2_exp_1_rlc_test_config.npz")
NUM_IO = 1
SEED = 2026  # the pinned inputs: g2_inputs(SEED, NUM_IO)
X_CELLS = 32  # public cells of x (and of offset), the first two in an instance's block

torch.set_num_threads(1)


def g2_inputs(seed: int, count: int):
    """(x, offset, scalar) per instance: x and offset multiples of the G2
    generator by scalars drawn as bench.py:61-88 draws them."""
    rng = np.random.default_rng(seed)

    def rand_scalar():
        return int.from_bytes(rng.bytes(40), "little") % bn254.R_BN

    return [
        (bn254.g2_mul(bn254.G2_GEN, rand_scalar()), bn254.g2_mul(bn254.G2_GEN, rand_scalar()),
         rand_scalar())
        for _ in range(count)
    ]


def encode_inputs(inputs) -> np.ndarray:
    """[count, 9, 8] u32 limbs of x.x0, x.x1, x.y0, x.y1, the offset's four,
    and the scalar."""
    return np.array([[fq_to_u32_limbs(v) for v in (*x[0], *x[1], *off[0], *off[1], e)]
                     for (x, off, e) in inputs], dtype=np.uint64)


def swap_x_and_offset(pi: np.ndarray) -> np.ndarray:
    """The public inputs with the instance's x and offset exchanged."""
    return np.concatenate([pi[X_CELLS : 2 * X_CELLS], pi[:X_CELLS], pi[2 * X_CELLS :]])


def air() -> G2ExpAir:
    return G2ExpAir(NUM_IO, range_check="logup", io_binding="rlc")


def jax_air() -> JaxG2ExpAir:
    return JaxG2ExpAir(NUM_IO, range_check="logup", io_binding="rlc")


INPUTS = g2_inputs(SEED, NUM_IO)


@pytest.fixture(scope="module")
def fixture():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def statement():
    return air().generate_trace_and_pi(INPUTS)


@pytest.fixture(scope="module")
def port_proof(statement):
    trace, pi = statement
    return prove(air(), trace, pi, StarkConfig.test_config(), device="cpu")


def test_fixture_holds_the_pinned_inputs(fixture):
    assert np.array_equal(fixture["inputs"], encode_inputs(INPUTS))


def test_trace_and_pi_match_jax(statement, fixture):
    trace, pi = statement
    jtrace, jpi = jax_air().generate_trace_and_pi(INPUTS)
    assert trace.shape == (512, 2312)
    assert np.array_equal(trace, jtrace)
    assert np.array_equal(pi, jpi)
    assert np.array_equal(pi, fixture["public_inputs"])


def test_exact_int_trace_matches_native_chain(statement):
    """The exact-int G2 gadgets, row by row, give the native chain's trace."""
    trace, pi = statement
    ref_trace, ref_pi = air().generate_trace_and_pi(INPUTS, exact=True)
    assert np.array_equal(trace, ref_trace)
    assert np.array_equal(pi, ref_pi)


def test_port_proof_is_fixture_bytes(port_proof, fixture):
    assert proof_to_bytes(port_proof) == fixture["proof_bytes"].tobytes()


def test_port_verifier_accepts_jax_proof(fixture):
    proof = proof_from_bytes(fixture["proof_bytes"].tobytes())
    assert verify(air(), proof, StarkConfig.test_config())


def test_jax_verifier_accepts_port_proof(port_proof):
    jproof = jax_proof_from_bytes(proof_to_bytes(port_proof))
    assert jax_verify(jax_air(), jproof, JaxStarkConfig.test_config())


def _tamper_opening(p):
    p.openings.z_zeta[7, 1] ^= np.uint64(1)


def _tamper_public_input(p):
    p.public_inputs[3] ^= np.uint64(1)


@pytest.mark.parametrize("tamper", [_tamper_opening, _tamper_public_input],
                         ids=["aux_opening", "public_input"])
def test_tampered_proof_rejected(port_proof, tamper):
    proof = proof_from_bytes(proof_to_bytes(port_proof))
    tamper(proof)
    with pytest.raises(VerificationError):
        verify(air(), proof, StarkConfig.test_config())
    with pytest.raises(JaxVerificationError):
        jax_verify(jax_air(), jax_proof_from_bytes(proof_to_bytes(proof)),
                   JaxStarkConfig.test_config())


def test_swapped_x_and_offset_rejected(statement, fixture):
    """The JAX prover's proof of the trace under public inputs whose x and
    offset are exchanged: the RLC binding makes both verifiers reject it."""
    _, pi = statement
    proof = proof_from_bytes(fixture["swapped_proof_bytes"].tobytes())
    assert np.array_equal(proof.public_inputs, swap_x_and_offset(pi))
    with pytest.raises(VerificationError):
        verify(air(), proof, StarkConfig.test_config())
    with pytest.raises(JaxVerificationError):
        jax_verify(jax_air(), jax_proof_from_bytes(fixture["swapped_proof_bytes"].tobytes()),
                   JaxStarkConfig.test_config())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_proof_is_fixture_bytes(statement, fixture, cuda_device):
    """On the card (every kernel and the logUp gather on CUDA tensors) the
    proof is the fixture's."""
    trace, pi = statement
    proof = prove(air(), xnp.to_torch(trace, cuda_device), pi, StarkConfig.test_config())
    assert proof_to_bytes(proof) == fixture["proof_bytes"].tobytes()


def _make_fixture() -> None:
    """Prove the statement and its x/offset-exchanged twin with the JAX
    package on the CPU and write the fixture."""
    jair, cfg = jax_air(), JaxStarkConfig.test_config()
    trace, pi = jair.generate_trace_and_pi(INPUTS)
    proof = jax_prove(jair, jnp.asarray(trace), pi, cfg)
    assert jax_verify(jair, proof, cfg)
    swapped = jax_prove(jair, jnp.asarray(trace), swap_x_and_offset(pi), cfg)
    try:
        jax_verify(jair, swapped, cfg)
    except JaxVerificationError:
        pass
    else:
        raise AssertionError("the JAX verifier accepted the exchanged proof")
    np.savez_compressed(
        FIXTURE,
        inputs=encode_inputs(INPUTS),
        public_inputs=pi,
        proof_bytes=np.frombuffer(jax_proof_to_bytes(proof), dtype=np.uint8),
        swapped_proof_bytes=np.frombuffer(jax_proof_to_bytes(swapped), dtype=np.uint8),
    )
    print("wrote", FIXTURE, os.path.getsize(FIXTURE), "bytes")


if __name__ == "__main__":
    _make_fixture()
