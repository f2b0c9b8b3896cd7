"""The G2 configuration's pieces on the CPU: its reference imports nothing
of the port, the frozen verifier judges the port's G2 proofs, the
reference's exact public cells are the port's, and the statement maker
never gives an instance x = offset."""

import os
import subprocess
import sys

import numpy as np

from benchtools import BENCH, ROOT

FIXTURES = os.path.join(ROOT, "tests", "fixtures")
STATEMENT = {"num_io": 1, "range_check": "logup", "io_binding": "rlc"}


def test_the_g2_reference_imports_nothing_of_the_port_or_jax():
    code = (f"import sys; sys.path.insert(0, {BENCH!r})\n"
            "import reference.verify, reference.g2_exp, inputs.g2_exp\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('starky_bn254_tpu_torch', 'starky_bn254_tpu', 'jax', 'jaxlib', 'flax')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd="/", timeout=300)


def test_the_frozen_verifier_judges_the_ports_g2_fixture_proof():
    """The port's G2ExpAir(1) proof (byte for byte its fixture) is accepted;
    the same trace proved under x and offset exchanged is rejected."""
    from reference import g2_exp as ref
    from reference import verify

    d = np.load(os.path.join(FIXTURES, "g2_exp_1_rlc_test_config.npz"))
    air, cfg = ref.air(STATEMENT), verify.stark_config({"preset": "test_config"})
    assert verify.rejection(air, verify.parse(d["proof_bytes"].tobytes()), cfg) is None
    assert verify.rejection(air, verify.parse(d["swapped_proof_bytes"].tobytes()), cfg) is not None


def test_reference_and_port_agree_on_a_fresh_g2_statement():
    """A G2ExpAir(1) statement from the benchmark's maker, proved by the
    port on the CPU: the frozen verifier accepts the proof, the reference's
    public cells are the port's, and an output cell changed counts one
    wrong instance."""
    from inputs import g2_exp
    from reference import g2_exp as ref
    from reference import verify
    from starky_bn254_tpu_torch import bn254
    from starky_bn254_tpu_torch.airs.g2_exp import G2ExpAir
    from starky_bn254_tpu_torch.stark import StarkConfig, proof_to_bytes, prove

    inputs = g2_exp.Maker(2**31 + 5, 1).request(0, 3)
    air = G2ExpAir(1, range_check="logup", io_binding="rlc")
    trace, pi = air.generate_trace_and_pi(g2_exp.program_form(inputs, bn254))
    raw = proof_to_bytes(prove(air, trace, pi, StarkConfig.test_config(), device="cpu"))
    proof = verify.parse(raw)
    cfg = verify.stark_config({"preset": "test_config"})
    assert verify.rejection(ref.air(STATEMENT), proof, cfg) is None
    assert ref.wrong_outputs(inputs, proof.public_inputs) == 0
    altered = np.array(proof.public_inputs)
    altered[-1] ^= 1
    assert ref.wrong_outputs(inputs, altered) == 1
    assert ref.wrong_outputs(inputs, altered[:-1]) == 1  # the wrong length: every instance


def test_the_g2_maker_never_draws_x_as_offset():
    from inputs import g2_exp
    from reference.frozen import bn254

    maker = g2_exp.Maker(2**33 + 1, 128)
    assert len(set(maker.pool)) == len(maker.pool)
    assert all(bn254.g2_is_on_curve(p) for p in maker.pool)
    for stream, i in ((0, 0), (0, 1), (1, 0), (0, 2**20)):
        req = maker.request(stream, i)
        assert len(req) == 128 and all(x != off for x, off, _ in req)
        assert all(0 <= e < bn254.R_BN for _, _, e in req)
    assert maker.request(0, 5) == g2_exp.Maker(2**33 + 1, 128).request(0, 5)
