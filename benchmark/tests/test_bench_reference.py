"""The plain reference: it imports nothing of the port, accepts the port's
proofs, rejects altered ones, and its exact public cells are the port's."""

import os
import subprocess
import sys

import numpy as np
import pytest

from benchtools import BENCH, ROOT

FIXTURES = os.path.join(ROOT, "tests", "fixtures")


def test_the_reference_imports_nothing_of_the_port_or_jax():
    code = (f"import sys; sys.path.insert(0, {BENCH!r})\n"
            "import reference.verify, reference.g1_exp, reference.fq12_exp, inputs.g1_exp, "
            "inputs.fq12_exp\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('starky_bn254_tpu_torch', 'starky_bn254_tpu', 'jax', 'jaxlib', 'flax')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd="/", timeout=300)
    for dirpath, _, files in os.walk(os.path.join(BENCH, "reference")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    src = fh.read()
                assert "import starky" not in src and "from starky" not in src, f
                assert "import jax" not in src and "from jax" not in src, f


@pytest.mark.parametrize("fixture, kind, statement", [
    ("g1_exp_2_rlc_test_config", "g1_exp", {"num_io": 2, "range_check": "logup", "io_binding": "rlc"}),
    ("fq12_exp_1_rlc_test_config", "fq12_exp", {"num_io": 1, "range_check": "logup",
                                                "io_binding": "rlc"}),
])
def test_the_frozen_verifier_judges_the_ports_fixture_proofs(fixture, kind, statement):
    """The port's proofs (byte for byte its fixtures) are accepted; the
    same statement with its instances exchanged is rejected."""
    import importlib

    from reference import verify

    ref = importlib.import_module(f"reference.{kind}")
    d = np.load(os.path.join(FIXTURES, fixture + ".npz"))
    air, cfg = ref.air(statement), verify.stark_config({"preset": "test_config"})
    assert verify.rejection(air, verify.parse(d["proof_bytes"].tobytes()), cfg) is None
    assert verify.rejection(air, verify.parse(d["swapped_proof_bytes"].tobytes()), cfg) is not None


def test_reference_and_port_agree_on_a_fresh_g1_statement():
    """A G1ExpAir(2) statement from the benchmark's maker, proved by the
    port on the CPU: the reference's public cells are the port's, its
    verifier accepts the proof and rejects it with one word changed."""
    from inputs import g1_exp
    from reference import g1_exp as ref
    from reference import verify
    from starky_bn254_tpu_torch.airs.g1_exp import G1ExpAir
    from starky_bn254_tpu_torch.stark import StarkConfig, proof_to_bytes, prove

    statement = {"num_io": 2, "range_check": "logup", "io_binding": "rlc"}
    inputs = g1_exp.Maker(2**31 + 5, 2).request(0, 3)
    air = G1ExpAir(2, range_check="logup", io_binding="rlc")
    trace, pi = air.generate_trace_and_pi(inputs)
    assert ref.wrong_outputs(inputs, pi) == 0
    raw = proof_to_bytes(prove(air, trace, pi, StarkConfig.test_config(), device="cpu"))
    cfg = verify.stark_config({"preset": "test_config"})
    assert verify.rejection(ref.air(statement), verify.parse(raw), cfg) is None
    altered = bytearray(raw)
    altered[len(raw) // 2] ^= 1
    assert verify.rejection(ref.air(statement), verify.parse(bytes(altered)), cfg) is not None


def test_reference_and_port_agree_on_fq12_public_cells():
    from inputs import fq12_exp
    from reference import fq12_exp as ref
    from starky_bn254_tpu_torch import bn254
    from starky_bn254_tpu_torch.airs.fq12_exp import Fq12ExpAir

    inputs = fq12_exp.Maker(2**31 + 6, 1).request(0, 0)
    _, pi = Fq12ExpAir(1, io_binding="rlc").generate_trace_and_pi(
        fq12_exp.program_form(inputs, bn254))
    assert ref.wrong_outputs(inputs, pi) == 0
    pi = np.array(pi)
    pi[-1] ^= 1
    assert ref.wrong_outputs(inputs, pi) == 1
