"""A two-term Fq12 multi-exponentiation with u64 exponents, end to end on
the CPU, through the port's entry point: prove_fq12_multiexp(xs, exps,
u64=True, cfg=test_config, io_binding="rlc", device="cpu") proves
Fq12ExpU64Air(2, range_check="logup", io_binding="rlc") (256 rows, 4402
trace columns; the reference's fq12_u64/circuit.rs:437-489 chaining). The
proof is held byte for byte against the one the JAX package's
prove_fq12_multiexp made of the same terms
(tests/fixtures/fq12_exp_u64_2_rlc_test_config.npz). verify_fq12_multiexp
accepts it and refuses a wrong result; the port's verifier accepts the JAX
proof; a tampered proof and the JAX proof of the trace under public inputs
whose two instances are exchanged are rejected.

No test here runs the JAX prover or the JAX verifier. The fixture is the
JAX prover's output, made op by op (the jitted prover's XLA compile of the
Fq12 composition runs for over an hour on a CPU; the arithmetic is exact,
so the bytes are the same) by

    JAX_DISABLE_JIT=1 python tests/test_torch_fq12_u64_e2e.py

(about 45 min on the CPU).
"""

import os
import sys

if __name__ == "__main__":  # run as a script: the repo on the path, JAX on the CPU
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from starky_bn254_tpu_torch import bn254  # noqa: E402
from starky_bn254_tpu_torch.airs import Fq12ExpU64Air  # noqa: E402
from starky_bn254_tpu_torch.airs.fq12_exp import fq12_limb_array  # noqa: E402
from starky_bn254_tpu_torch.airs.fq12_exp_u64 import FQ12_EXP_U64_IO_LEN  # noqa: E402
from starky_bn254_tpu_torch.compose import (  # noqa: E402
    msm,
    prove_fq12_multiexp,
    verify_fq12_multiexp,
)
from starky_bn254_tpu_torch.stark import (  # noqa: E402
    StarkConfig,
    VerificationError,
    proof_from_bytes,
    proof_to_bytes,
    verify,
)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "fq12_exp_u64_2_rlc_test_config.npz")
NUM_TERMS = 2
SEED = 2027  # the pinned terms: multiexp_terms(SEED, NUM_TERMS)

torch.set_num_threads(1)


def multiexp_terms(seed: int, count: int):
    """(xs, exps): random Fq12 values and exponents below 2^63."""
    rng = np.random.default_rng(seed)

    def rand_fq12():
        return bn254.Fq12.from_fq_list(
            [int.from_bytes(rng.bytes(40), "little") % bn254.P_BN for _ in range(12)])

    xs = [rand_fq12() for _ in range(count)]
    exps = [int(e) for e in rng.integers(0, 1 << 63, size=count, dtype=np.uint64)]
    return xs, exps


def swap_instances(pi: np.ndarray) -> np.ndarray:
    """The public inputs with the two instances' blocks exchanged."""
    n = FQ12_EXP_U64_IO_LEN
    return np.concatenate([pi[n : 2 * n], pi[:n], pi[2 * n :]])


def air() -> Fq12ExpU64Air:
    return Fq12ExpU64Air(NUM_TERMS, range_check="logup", io_binding="rlc")


XS, EXPS = multiexp_terms(SEED, NUM_TERMS)


@pytest.fixture(scope="module")
def fixture():
    with np.load(FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def port_run():
    """(proof, result, air, n_real) from the port's entry point."""
    return prove_fq12_multiexp(XS, EXPS, u64=True, cfg=StarkConfig.test_config(),
                               io_binding="rlc", device="cpu")


def test_fixture_holds_the_pinned_terms(fixture):
    assert np.array_equal(fixture["xs"], fq12_limb_array(XS))
    assert fixture["exps"].tolist() == EXPS


def test_entry_point_statement(port_run, fixture):
    proof, result, run_air, n_real = port_run
    assert (type(run_air), run_air.num_io, run_air.io_binding, run_air.range_check) \
        == (Fq12ExpU64Air, 2, "rlc", "logup")
    assert run_air.num_columns == 4402 and n_real == 2
    expected = bn254.Fq12.one()
    for x, e in zip(XS, EXPS):
        expected = expected * x.pow(e)
    assert result.coeffs == expected.coeffs
    assert np.array_equal(fq12_limb_array([result])[0], fixture["result"])
    assert np.array_equal(proof.public_inputs, fixture["public_inputs"])


def test_port_proof_is_fixture_bytes(port_run, fixture):
    assert proof_to_bytes(port_run[0]) == fixture["proof_bytes"].tobytes()


def test_verify_fq12_multiexp(port_run, monkeypatch):
    """Accepts the proven product; refuses another one: the STARK holds
    (checked once, then taken as given), the chain's last output does not
    match."""
    proof, result, run_air, n_real = port_run
    cfg = StarkConfig.test_config()
    assert verify_fq12_multiexp(proof, result, run_air, n_real, u64=True, cfg=cfg)
    monkeypatch.setattr(msm, "verify", lambda air, proof, cfg: True)
    assert not verify_fq12_multiexp(proof, result * XS[0], run_air, n_real, u64=True, cfg=cfg)


def test_port_verifier_accepts_jax_proof(fixture):
    proof = proof_from_bytes(fixture["proof_bytes"].tobytes())
    assert verify(air(), proof, StarkConfig.test_config())


def test_tampered_proof_rejected(port_run):
    proof = proof_from_bytes(proof_to_bytes(port_run[0]))
    proof.openings.trace_zeta[200, 1] ^= np.uint64(1)
    with pytest.raises(VerificationError):
        verify(air(), proof, StarkConfig.test_config())


def test_swapped_instances_rejected(fixture):
    """The JAX prover's proof of the trace under public inputs whose two
    instances are exchanged: the RLC binding makes the verifier reject it."""
    proof = proof_from_bytes(fixture["swapped_proof_bytes"].tobytes())
    assert np.array_equal(proof.public_inputs, swap_instances(fixture["public_inputs"]))
    with pytest.raises(VerificationError):
        verify(air(), proof, StarkConfig.test_config())


@pytest.mark.cuda
def test_card_proof_is_fixture_bytes(fixture):
    """On the card, through the entry point's default device, the proof is
    the fixture's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    proof, _, _, _ = prove_fq12_multiexp(XS, EXPS, u64=True, cfg=StarkConfig.test_config(),
                                         io_binding="rlc")
    assert proof_to_bytes(proof) == fixture["proof_bytes"].tobytes()


def _make_fixture() -> None:
    """Prove the terms with the JAX package's prove_fq12_multiexp on the
    CPU, and the trace under exchanged instances, and write the fixture."""
    import jax.numpy as jnp

    from starky_bn254_tpu.bn254 import Fq12 as JaxFq12
    from starky_bn254_tpu.compose import msm as jmsm
    from starky_bn254_tpu.stark import StarkConfig as JaxStarkConfig
    from starky_bn254_tpu.stark import VerificationError as JaxVerificationError
    from starky_bn254_tpu.stark import prove as jax_prove
    from starky_bn254_tpu.stark import verify as jax_verify
    from starky_bn254_tpu.stark.proof import proof_to_bytes as jax_proof_to_bytes

    cfg = JaxStarkConfig.test_config()
    jxs = [JaxFq12(x.coeffs) for x in XS]
    proof, result, jair, n_real = jmsm.prove_fq12_multiexp(jxs, EXPS, u64=True, cfg=cfg,
                                                           io_binding="rlc")
    assert jmsm.verify_fq12_multiexp(proof, result, jair, n_real, u64=True, cfg=cfg)
    inputs, _ = jmsm.Fq12MultiExp(u64=True).build_inputs(jxs, EXPS)
    trace, pi = jair.generate_trace_and_pi(jmsm.pad_instances(inputs))
    assert np.array_equal(pi, proof.public_inputs)
    swapped = jax_prove(jair, jnp.asarray(trace), swap_instances(pi), cfg)
    try:
        jax_verify(jair, swapped, cfg)
    except JaxVerificationError:
        pass
    else:
        raise AssertionError("the JAX verifier accepted the exchanged proof")
    np.savez_compressed(
        FIXTURE,
        xs=fq12_limb_array(XS),
        exps=np.array(EXPS, dtype=np.uint64),
        result=fq12_limb_array([bn254.Fq12(result.coeffs)])[0],
        public_inputs=pi,
        proof_bytes=np.frombuffer(jax_proof_to_bytes(proof), dtype=np.uint8),
        swapped_proof_bytes=np.frombuffer(jax_proof_to_bytes(swapped), dtype=np.uint8),
    )
    print("wrote", FIXTURE, os.path.getsize(FIXTURE), "bytes")


if __name__ == "__main__":
    _make_fixture()
