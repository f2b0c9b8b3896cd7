"""The port's pipelined prover (starky_bn254_tpu_torch.stark.pipeline) on
the CPU: FqMulAir(256) under test_config, three batches through
prove_pipelined against three sequential proves of the same inputs, and the
first batch (the fixture's statement) against
tests/fixtures/fq_mul_256_test_config.npz, which the JAX package made, with
the pipeline's spans recorded. An abort leaves no child process; cancel()
after join() sends no signal; with no card and no device named it raises.
"""

import os

import numpy as np
import pytest
import torch

from starky_bn254_tpu_torch import bn254
from starky_bn254_tpu_torch.airs.fq_mul import FqMulAir
from starky_bn254_tpu_torch.stark import (StarkConfig, load_proof, proof_to_bytes, prove,
                                          prove_pipelined)
from starky_bn254_tpu_torch.stark import pipeline
from starky_bn254_tpu_torch.utils import timing as tm

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                       "fq_mul_256_test_config.npz")
CFG = StarkConfig.test_config()

torch.set_num_threads(1)


class PipelineFqMulAir(FqMulAir):
    """FqMulAir with the generate_trace_and_pi entry point prove_pipelined
    calls (FqMulAir has no public inputs)."""

    def generate_trace_and_pi(self, inputs):
        if inputs == "raise":
            raise ValueError("tracegen asked to fail")
        return self.generate_trace(inputs), np.zeros(0, dtype=np.uint64)


def fq_inputs(seed: int, count: int):
    """The fixture's input maker (tests/test_torch_fq_mul_e2e.py)."""
    rng = np.random.default_rng(seed)
    return [(int.from_bytes(rng.bytes(40), "little") % bn254.P_BN,
             int.from_bytes(rng.bytes(40), "little") % bn254.P_BN) for _ in range(count)]


AIR = PipelineFqMulAir(256)
BATCHES = [fq_inputs(seed, 250) for seed in (42, 5, 6)]  # seed 42: the fixture's


def _no_children() -> bool:
    try:
        os.waitpid(-1, os.WNOHANG)
    except ChildProcessError:
        return True
    return False


def test_pipelined_proofs_equal_sequential_proves_and_the_fixture():
    """Recorded (utils.timing), each stage once a batch with the batch's
    index; the sequential proves beside them record nothing."""
    stamps = []
    rec = tm.Recorder("stream")
    with tm.recording(rec):
        proofs = prove_pipelined(AIR, BATCHES, CFG, on_proof=lambda i, t: stamps.append((i, t)),
                                 device="cpu")
    assert [i for i, _ in stamps] == [0, 1, 2]
    for stage in ("wait", "prove", "trim", "read", "worker tracegen"):
        requests = [s.request for s in rec.spans if s.path == "pipeline/" + stage]
        assert sorted(requests) == [0, 1, 2], stage
    assert all(a[1] <= b[1] for a, b in zip(stamps, stamps[1:]))
    # batch 0 is the fixture's statement, whose sequential port proof is the
    # fixture's bytes (tests/test_torch_fq_mul_e2e.py)
    assert proof_to_bytes(proofs[0]) == proof_to_bytes(load_proof(FIXTURE))
    for inputs, got in zip(BATCHES[1:], proofs[1:]):
        trace, pi = AIR.generate_trace_and_pi(inputs)
        assert proof_to_bytes(got) == proof_to_bytes(prove(AIR, trace, pi, CFG, device="cpu"))
    assert _no_children()


def test_abort_in_on_proof_reraises_and_leaves_no_child():
    def on_proof(i, t):
        raise KeyboardInterrupt("stop after the first proof")

    with pytest.raises(KeyboardInterrupt, match="first proof"):
        prove_pipelined(AIR, BATCHES, CFG, on_proof=on_proof, device="cpu")
    assert _no_children()


def test_worker_error_is_raised_in_the_caller():
    with pytest.raises(RuntimeError, match="tracegen asked to fail"):
        prove_pipelined(AIR, ["raise"], CFG, device="cpu")
    assert _no_children()


def test_cancel_after_join_sends_no_signal(monkeypatch):
    """The reaped child's PID may already belong to another process: cancel()
    after join() must not signal it (the JAX pipeline's cancel() does)."""
    worker = pipeline._Tracegen(AIR, BATCHES[0])
    trace, pi = worker.join(pin=False)
    assert tuple(trace.shape) == (256, AIR.num_columns) and pi.shape == (0,)
    sent = []
    monkeypatch.setattr(os, "kill", lambda pid, sig: sent.append((pid, sig)))
    worker.cancel()
    worker.cancel()
    assert sent == []
    assert _no_children()


def test_cancel_kills_a_running_worker():
    """Nobody reads the pipe, so the worker blocks writing its trace until
    it is killed; join() then finds a short pipe."""
    worker = pipeline._Tracegen(AIR, fq_inputs(9, 250))
    worker.cancel()
    assert _no_children()
    with pytest.raises(RuntimeError, match="tracegen worker"):
        worker.join(pin=False)


def test_without_a_card_it_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        prove_pipelined(AIR, BATCHES[:1], CFG)
    assert _no_children()
