"""Sharded proving in the port on the CPU, continued from
tests/test_torch_sharded_prove.py: FqExpAir(2, logup, rlc) (an aux commit,
logUp and the RLC binding through the sharded commit and composition) over
2 and 4 shards gives the bytes of the JAX-made fixture
tests/fixtures/fq_exp_2_rlc_test_config.npz (which the single-device
prove gives, tests/test_torch_fq_exp_e2e.py), and prove_pipelined over a
mesh gives the sequential proves' bytes. No JAX prover runs here.
"""

import os

import numpy as np
import pytest
import torch

from starky_bn254_tpu_torch import bn254
from starky_bn254_tpu_torch.airs.fq_exp import FqExpAir
from starky_bn254_tpu_torch.airs.fq_mul import FqMulAir
from starky_bn254_tpu_torch.parallel import sharded
from starky_bn254_tpu_torch.stark import (StarkConfig, load_proof, proof_to_bytes, prove,
                                          prove_pipelined)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
CFG = StarkConfig.test_config()

torch.set_num_threads(1)


class PipelineFqMulAir(FqMulAir):
    """FqMulAir with the generate_trace_and_pi entry point prove_pipelined
    calls (tests/test_torch_pipeline.py)."""

    def generate_trace_and_pi(self, inputs):
        return self.generate_trace(inputs), np.zeros(0, dtype=np.uint64)


def fq_inputs(seed: int, count: int):
    """tests/test_torch_fq_mul_e2e.py's input maker."""
    rng = np.random.default_rng(seed)
    return [(int.from_bytes(rng.bytes(40), "little") % bn254.P_BN,
             int.from_bytes(rng.bytes(40), "little") % bn254.P_BN) for _ in range(count)]


def fq_exp_inputs(seed: int, count: int):
    """tests/test_torch_fq_exp_e2e.py's input maker."""
    rng = np.random.default_rng(seed)

    def rand_scalar():
        return int.from_bytes(rng.bytes(40), "little") % bn254.R_BN

    def rand_fq():
        return int.from_bytes(rng.bytes(40), "little") % bn254.P_BN

    return [(rand_fq(), rand_fq(), rand_scalar()) for _ in range(count)]


@pytest.mark.parametrize("d", [2, 4])
def test_fq_exp_mesh_proof_is_the_fixture(d):
    air = FqExpAir(2, range_check="logup", io_binding="rlc")
    trace, pi = air.generate_trace_and_pi(fq_exp_inputs(2026, 2))
    proof = prove(air, trace, pi, CFG, mesh=sharded.make_mesh(d, device="cpu"))
    with np.load(os.path.join(FIXTURES, "fq_exp_2_rlc_test_config.npz")) as f:
        assert proof_to_bytes(proof) == f["proof_bytes"].tobytes()


def test_pipelined_mesh_proofs_equal_the_sequential_proves():
    """tests/test_torch_pipeline.py's statement over 2 shards: batch 0 is
    the fixture's inputs (its sequential prove gives the fixture's bytes),
    batch 1 another seed, held against a single-device prove."""
    air = PipelineFqMulAir(256)
    batches = [fq_inputs(42, 250), fq_inputs(5, 250)]
    proofs = prove_pipelined(air, batches, CFG, mesh=sharded.make_mesh(2, device="cpu"))
    assert proof_to_bytes(proofs[0]) == proof_to_bytes(
        load_proof(os.path.join(FIXTURES, "fq_mul_256_test_config.npz")))
    trace, pi = air.generate_trace_and_pi(batches[1])
    assert proof_to_bytes(proofs[1]) == proof_to_bytes(prove(air, trace, pi, CFG, device="cpu"))
