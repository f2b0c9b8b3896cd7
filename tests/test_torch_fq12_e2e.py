"""Fq12 exponentiation at test size, end to end on the CPU:
Fq12ExpAir(1, range_check="logup", io_binding="rlc") under test_config (512
rows, 4412 trace columns), proved by starky_bn254_tpu_torch and held byte
for byte against a proof the JAX package made of the same inputs
(tests/fixtures/fq12_exp_1_rlc_test_config.npz). The port's verifier
accepts the JAX proof; a tampered proof, and the JAX proof of the trace
under public inputs whose x and offset are exchanged (one instance has no
partner to swap with), are rejected.

No test here runs the JAX prover or the JAX verifier (their XLA compiles
take minutes at this width): the port's proof equals the JAX proof byte for
byte. The fixture is the JAX prover's output, made op by op (the jitted
prover's XLA compile of the Fq12 composition runs for over an hour on a
CPU; the arithmetic is exact, so the bytes are the same) by

    JAX_DISABLE_JIT=1 python tests/test_torch_fq12_e2e.py

which proves the statement and the exchanged one with the JAX package
(about 45 min on the CPU) and writes the fixture.
"""

import os
import sys

if __name__ == "__main__":  # run as a script: the repo on the path, JAX on the CPU
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from starky_bn254_tpu.airs.fq12_exp import Fq12ExpAir as JaxFq12ExpAir  # noqa: E402
from starky_bn254_tpu.bn254 import Fq12 as JaxFq12  # noqa: E402
from starky_bn254_tpu_torch import bn254, xnp  # noqa: E402
from starky_bn254_tpu_torch.airs import Fq12ExpAir  # noqa: E402
from starky_bn254_tpu_torch.stark import (  # noqa: E402
    StarkConfig,
    VerificationError,
    proof_from_bytes,
    proof_to_bytes,
    prove,
    verify,
)
from starky_bn254_tpu_torch.utils.conversions import int_to_limbs  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "fq12_exp_1_rlc_test_config.npz")
NUM_IO = 1
SEED = 2026  # the pinned inputs: fq12_inputs(SEED, NUM_IO)
X_CELLS = 12 * 16  # public cells of x (and of offset), the first two in an instance's block

torch.set_num_threads(1)


def fq12_inputs(seed: int, count: int):
    """(x, offset, exponent) per instance: random Fq12 values and a 256-bit
    scalar, drawn as scripts/heavy_standard_config.py:31-40 draws them."""
    rng = np.random.default_rng(seed)

    def rand_fq():
        return int.from_bytes(rng.bytes(40), "little") % bn254.P_BN

    def rand_fq12():
        return bn254.Fq12.from_fq_list([rand_fq() for _ in range(12)])

    def rand_scalar():
        return int.from_bytes(rng.bytes(40), "little") % bn254.R_BN

    return [(rand_fq12(), rand_fq12(), rand_scalar()) for _ in range(count)]


def encode_inputs(inputs) -> np.ndarray:
    """[count, 25, 16] u16 limbs of x's 12 Fq values, the offset's and the
    exponent."""
    return np.array([[int_to_limbs(v) for v in (*x.to_fq_list(), *off.to_fq_list(), e)]
                     for (x, off, e) in inputs], dtype=np.uint64)


def swap_x_and_offset(pi: np.ndarray) -> np.ndarray:
    """The public inputs with the instance's x and offset exchanged."""
    return np.concatenate([pi[X_CELLS : 2 * X_CELLS], pi[:X_CELLS], pi[2 * X_CELLS :]])


def air() -> Fq12ExpAir:
    return Fq12ExpAir(NUM_IO, range_check="logup", io_binding="rlc")


def jax_air() -> JaxFq12ExpAir:
    return JaxFq12ExpAir(NUM_IO, range_check="logup", io_binding="rlc")


INPUTS = fq12_inputs(SEED, NUM_IO)


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
    jtrace, jpi = jax_air().generate_trace_and_pi(
        [(JaxFq12(x.coeffs), JaxFq12(off.coeffs), e) for (x, off, e) in INPUTS])
    assert trace.shape == (512, 4412)
    assert np.array_equal(trace, jtrace)
    assert np.array_equal(pi, jpi)
    assert np.array_equal(pi, fixture["public_inputs"])


def test_port_proof_is_fixture_bytes(port_proof, fixture):
    assert proof_to_bytes(port_proof) == fixture["proof_bytes"].tobytes()


def test_port_verifier_accepts_jax_proof(fixture):
    proof = proof_from_bytes(fixture["proof_bytes"].tobytes())
    assert verify(air(), proof, StarkConfig.test_config())


def _tamper_opening(p):
    p.openings.trace_zeta[100, 0] ^= np.uint64(1)


def _tamper_rlc_opening(p):
    p.openings.z_zeta[-1, 1] ^= np.uint64(1)


def _tamper_public_input(p):
    p.public_inputs[3] ^= np.uint64(1)


@pytest.mark.parametrize("tamper", [_tamper_opening, _tamper_rlc_opening, _tamper_public_input],
                         ids=["trace_opening", "rlc_opening", "public_input"])
def test_tampered_proof_rejected(port_proof, tamper):
    proof = proof_from_bytes(proof_to_bytes(port_proof))
    tamper(proof)
    with pytest.raises(VerificationError):
        verify(air(), proof, StarkConfig.test_config())


def test_swapped_x_and_offset_rejected(statement, fixture):
    """The JAX prover's proof of the trace under public inputs whose x and
    offset are exchanged: the RLC binding makes the verifier reject it."""
    _, pi = statement
    proof = proof_from_bytes(fixture["swapped_proof_bytes"].tobytes())
    assert np.array_equal(proof.public_inputs, swap_x_and_offset(pi))
    with pytest.raises(VerificationError):
        verify(air(), proof, StarkConfig.test_config())


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
    import jax.numpy as jnp

    from starky_bn254_tpu.stark import StarkConfig as JaxStarkConfig
    from starky_bn254_tpu.stark import VerificationError as JaxVerificationError
    from starky_bn254_tpu.stark import prove as jax_prove
    from starky_bn254_tpu.stark import verify as jax_verify
    from starky_bn254_tpu.stark.proof import proof_to_bytes as jax_proof_to_bytes

    jair, cfg = jax_air(), JaxStarkConfig.test_config()
    trace, pi = jair.generate_trace_and_pi(
        [(JaxFq12(x.coeffs), JaxFq12(off.coeffs), e) for (x, off, e) in INPUTS])
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
