"""`correct` comes out false when the timed path is broken underneath: a
run of each tiny cell on the CPU, with a fault planted in the port before
it starts and the rest of the run as run.py does it (the look for a card
skipped). The faults a proving cell can have: an answer altered where it
is produced (a proof's word, an instance's output) and part of the batch
left out (half the instances proved in place of the others, half a
stream's proofs lost). Cells of one chip exchange nothing between chips;
a proof has no state that a step could leave unchanged."""

import pytest

from benchtools import run_cpu, tiny_bench  # noqa: F401 (a fixture)

PROOF_WORD = """
import starky_bn254_tpu_torch.stark.prover as prover
fri_prove = prover.fri_prove
def altered(*args, **kwargs):
    out = fri_prove(*args, **kwargs)
    out.final_coeffs = out.final_coeffs.copy()
    out.final_coeffs[0, 0] ^= 1
    return out
prover.fri_prove = altered
"""

OUTPUT_CELL = """
from starky_bn254_tpu_torch.airs.g1_exp import G1ExpAir
gen = G1ExpAir.generate_trace_and_pi
def altered(self, inputs, exact=False):
    trace, pi = gen(self, inputs, exact)
    pi = pi.copy()
    pi[-1] ^= 1
    return trace, pi
G1ExpAir.generate_trace_and_pi = altered
"""

HALF_THE_INSTANCES = """
from starky_bn254_tpu_torch.airs.g1_exp import G1ExpAir
gen = G1ExpAir.generate_trace_and_pi
def half(self, inputs, exact=False):
    k = len(inputs) // 2
    return gen(self, list(inputs[:k]) * 2, exact)
G1ExpAir.generate_trace_and_pi = half
"""

HALF_THE_STREAM = """
import starky_bn254_tpu_torch.stark as stark
stream = stark.prove_pipelined
streams = []
def half(air, batches, cfg, **kwargs):
    proofs = stream(air, batches, cfg, **kwargs)
    streams.append(len(batches))
    return proofs[: len(proofs) // 2] if len(streams) > 1 else proofs  # the first is set-up's
stark.prove_pipelined = half
"""


@pytest.mark.parametrize("cell, patch, failing", [
    ("g1-exp-2.closed", PROOF_WORD, "rejected"),
    ("g1-exp-2.closed", OUTPUT_CELL, "wrong_outputs"),
    ("g1-exp-2.closed", HALF_THE_INSTANCES, "wrong_outputs"),
    ("g1-exp-2.stream", HALF_THE_STREAM, "unproven"),
], ids=["proof-word", "output-cell", "half-the-instances", "half-the-stream"])
def test_a_broken_timed_path_is_not_correct(tiny_bench, cell, patch, failing):
    out = run_cpu(tiny_bench, cell, seed=2**31 + 17, patch=patch)
    assert out["correct"] is False
    assert out["checks"][failing]["value"] > out["checks"][failing]["limit"]


def test_the_sound_stream_is_correct(tiny_bench):
    out = run_cpu(tiny_bench, "g1-exp-2.stream", seed=2**31 + 17)
    assert out["correct"] is True and out["failed"] == 0
    assert set(out["metrics"]) == {"instances_per_s", "setup_s"}
