"""Sharded proving in the port on the CPU: `prove(mesh=make_mesh(d,
device="cpu"))` of FqMulAir(256) must give the bytes of the JAX-made
fixture, which the single-device prove gives (tests/test_torch_fq_mul_e2e.py),
over 2 and 4 shards (the collectives and folds are held against JAX at 1 to
8 shards in tests/test_torch_sharded.py). Both packages' verifiers accept a
mesh proof; a device other than the mesh's first is refused. The two
scripts that drive mesh proves, scaling_curve and collectives_report, run
at their smallest sizes, and refuse a mesh of more cards than the host has.
No JAX prover runs here (tests/test_torch_sharded_prove_aux.py: the aux
path and the pipeline).
"""

import os

import numpy as np
import pytest
import torch

from starky_bn254_tpu.airs.fq_mul import FqMulAir as JaxFqMulAir
from starky_bn254_tpu.stark import StarkConfig as JaxStarkConfig
from starky_bn254_tpu.stark import verify as jax_verify
from starky_bn254_tpu.stark.proof import proof_from_bytes as jax_proof_from_bytes
from starky_bn254_tpu_torch import bn254
from starky_bn254_tpu_torch.airs.fq_mul import FqMulAir
from starky_bn254_tpu_torch.parallel import sharded
from starky_bn254_tpu_torch.scripts import collectives_report, scaling_curve
from starky_bn254_tpu_torch.stark import (StarkConfig, load_proof, proof_to_bytes, prove,
                                          prove_pipelined, verify)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
CFG = StarkConfig.test_config()
NO_PI = np.zeros(0, dtype=np.uint64)

torch.set_num_threads(1)


def fq_inputs(seed: int, count: int):
    """tests/test_torch_fq_mul_e2e.py's input maker."""
    rng = np.random.default_rng(seed)
    return [(int.from_bytes(rng.bytes(40), "little") % bn254.P_BN,
             int.from_bytes(rng.bytes(40), "little") % bn254.P_BN) for _ in range(count)]


class PipelineFqMulAir(FqMulAir):
    """FqMulAir with the generate_trace_and_pi entry point prove_pipelined
    calls (tests/test_torch_pipeline.py)."""

    def generate_trace_and_pi(self, inputs):
        return self.generate_trace(inputs), NO_PI


@pytest.fixture(scope="module")
def fq_mul_trace():
    return FqMulAir(256).generate_trace(fq_inputs(42, 250))  # the fixture's statement


@pytest.fixture(scope="module")
def mesh_proofs():
    """Mesh proofs by their mesh size, kept for the verifier test."""
    return {}


@pytest.mark.parametrize("d", [2, 4])
def test_fq_mul_mesh_proof_is_the_fixture(d, fq_mul_trace, mesh_proofs):
    sharded.reset_counters()
    proof = prove(FqMulAir(256), fq_mul_trace, NO_PI, CFG, mesh=sharded.make_mesh(d, device="cpu"))
    assert proof_to_bytes(proof) == proof_to_bytes(
        load_proof(os.path.join(FIXTURES, "fq_mul_256_test_config.npz")))
    # the trace and aux commits went through the mesh: one record each
    assert [r["fn"] for r in sharded.SHARD_LAUNCHES] == ["sharded_commit_tree"] * 2
    assert all(len(r["k1"]) == d for r in sharded.SHARD_LAUNCHES)
    assert sharded.CALLS["ppermute"] == 2  # composition's halo, one per oracle
    assert sharded.BYTES["all_to_all"] > 0
    mesh_proofs[d] = proof


def test_both_verifiers_accept_a_mesh_proof(fq_mul_trace, mesh_proofs):
    proof = mesh_proofs.get(4) or prove(FqMulAir(256), fq_mul_trace, NO_PI, CFG,
                                        mesh=sharded.make_mesh(4, device="cpu"))
    assert verify(FqMulAir(256), proof, CFG)
    assert jax_verify(JaxFqMulAir(256), jax_proof_from_bytes(proof_to_bytes(proof)),
                      JaxStarkConfig.test_config())


def test_a_device_other_than_the_mesh_first_is_refused(fq_mul_trace):
    mesh = sharded.make_mesh(2, device="cpu")
    with pytest.raises(ValueError, match="not the mesh's first device"):
        prove(FqMulAir(256), fq_mul_trace, NO_PI, CFG, mesh=mesh, device="cuda:0")
    with pytest.raises(ValueError, match="not the mesh's first device"):
        prove_pipelined(PipelineFqMulAir(256), [fq_inputs(42, 250)], CFG, mesh=mesh, device="cuda:0")


def test_scaling_curve_on_one_device():
    recs = scaling_curve.run(["fq_18"], sizes=(1, 2), num_io=1, repeat=1, device="cpu")
    assert [r["mesh"] for r in recs] == [1, 2] and recs[0]["device"] == "cpu"
    assert {r["mode"] for r in recs} == {"one_device"}
    assert recs[0]["speedup_vs_first"] == 1.0 and all(r["prove_warm_s"] > 0 for r in recs)
    assert recs[0]["bytes_between_shards"] == 0 < recs[1]["bytes_between_shards"]
    assert recs[1]["bytes_copied_between_cards"] == 0  # one device


def test_collectives_report_on_one_device():
    out = collectives_report.run("fq_mul", shards=2, device="cpu")
    table = out["collectives"]
    assert out["mode"] == "one_device"
    # the trace and aux commits, then each FRI fold that splits over the shards
    assert table["all_to_all"]["calls"] > 2 and table["all_to_all"]["bytes"] > 0
    assert table["ppermute"]["calls"] == 2  # composition's halo, one per oracle
    assert all(r["copy_bytes"] == 0 for r in table.values())  # one device
    assert [len(r["k1"]) for r in out["shard_launches"]] == [2, 2]


@pytest.mark.parametrize("script", ["scaling_curve", "collectives_report"])
def test_mesh_scripts_refuse_more_cards_than_the_host_has(script, monkeypatch):
    """No device named: every mesh is cards, never some sizes on cards and
    the rest on one card; too few cards raise before any statement is made."""
    for module in (scaling_curve, collectives_report):
        monkeypatch.setattr(module, "statement", lambda *a: pytest.fail("work began"))
    with pytest.raises(RuntimeError, match="CUDA card"):
        if script == "scaling_curve":
            scaling_curve.run(["g1_16"], sizes=(1, 2, 64))
        else:
            collectives_report.run("g1", shards=64)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_mesh_proof_is_the_fixture(fq_mul_trace, cuda_device):
    """Four shards of one card: the fixture's bytes, with K1 and the leaf
    hasher (K3 under test_config) launched on every shard of both commits."""
    sharded.reset_counters()
    proof = prove(FqMulAir(256), fq_mul_trace, NO_PI, CFG,
                  mesh=sharded.make_mesh(4, device=cuda_device))
    assert proof_to_bytes(proof) == proof_to_bytes(
        load_proof(os.path.join(FIXTURES, "fq_mul_256_test_config.npz")))
    assert len(sharded.SHARD_LAUNCHES) == 2
    assert all(min(r["k1"]) > 0 and min(r["leaf"]) > 0 for r in sharded.SHARD_LAUNCHES)
