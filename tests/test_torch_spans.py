"""The port's span recorder (starky_bn254_tpu_torch.utils.timing) on the
CPU: spans nest per thread with their parents, request ids and counts on
time.time_ns(); with timing off a prove and a prove_pipelined build no
recorder and no span and reach no barrier; a barrier tree synchronizes at
its phases only; under torch.profiler with no recorder set a prove records
into DEVICE_TRACE; prove_pipelined records its stages once per batch with
the batch's index and proves what sequential proves prove (on the card too,
with each staging copy's device time); chip_smoke's busy share counts
overlapping activity once; the G1 and G2 tracegen record their parts;
composition's row blocks split into the AIR's constraints and the
arguments' (on the card, with their field launches). A 64 x 3 AIR keeps
each prove well under a second."""

import os
import sys
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from starky_bn254_tpu_torch import bn254
from starky_bn254_tpu_torch import goldilocks as gl
from starky_bn254_tpu_torch.airs.g1_exp import G1ExpAir
from starky_bn254_tpu_torch.airs.g2_exp import G2ExpAir
from starky_bn254_tpu_torch.stark import (Air, StarkConfig, proof_to_bytes, prove,
                                          prove_pipelined, verify)
from starky_bn254_tpu_torch.utils import timing as tm

CFG = StarkConfig.test_config()

torch.set_num_threads(1)


class FibAir(Air):
    """A Fibonacci pair and its product, 64 rows: a statement the CPU proves
    in a fraction of a second."""

    num_columns = 3
    num_public_inputs = 0

    def generate_trace_and_pi(self, inputs):
        a, b = inputs
        rows = []
        for _ in range(64):
            rows.append([a, b, a * b % gl.P])
            a, b = b, (a + b) % gl.P
        return np.array(rows, dtype=np.uint64), np.zeros(0, dtype=np.uint64)

    def eval(self, lv, nv, pi, cc):
        a, b = lv.col(0), lv.col(1)
        cc.constraint(lv.col(2) - a * b)
        cc.constraint_transition(nv.col(0) - b)
        cc.constraint_transition(nv.col(1) - (a + b))


class PairedFibAir(FibAir):
    """FibAir with a fourth column holding the first one's values in reverse
    order, a permutation pair: its composition has argument constraints."""

    num_columns = 4

    def generate_trace_and_pi(self, inputs):
        trace, pi = super().generate_trace_and_pi(inputs)
        return np.concatenate([trace, trace[::-1, :1]], axis=1), pi

    def permutation_pairs(self):
        return [(0, 3)]


AIR = FibAir()
BATCHES = [(1, 2), (3, 5), (8, 13)]


def find(rec, path: str) -> list:
    return [s for s in rec.spans if s.path == path]


@pytest.fixture
def counted(monkeypatch):
    """Counts of what the recorder builds and of its barriers."""
    n = {"spans": 0, "recorders": 0, "syncs": 0}
    span_init, rec_init, sync = tm.Span.__init__, tm.Recorder.__init__, tm._sync

    def counting(key, fn):
        def wrapper(*args, **kwargs):
            n[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(tm.Span, "__init__", counting("spans", span_init))
    monkeypatch.setattr(tm.Recorder, "__init__", counting("recorders", rec_init))
    monkeypatch.setattr(tm, "_sync", counting("syncs", sync))
    monkeypatch.setattr(torch.cuda, "synchronize", counting("syncs", lambda *a, **k: None))
    return n


def test_spans_nest_per_thread_with_parents_requests_and_the_wall_clock():
    rec = tm.Recorder("run")
    seen = []

    def side():
        seen.append(tm.current())  # recording() set rec for its own thread only
        with rec.span("side", request=9):
            pass

    w0 = time.time_ns()
    with tm.recording(rec):
        with tm.request(7), tm.span("outer", rows=4):
            with tm.span("inner"):
                tm.count(blocks=2)
            other = threading.Thread(target=side)
            other.start()
            other.join()
        rec.add("stamped", 5, 11, request=3)
    w1 = time.time_ns()
    by_path = {s.path: s for s in rec.spans}
    assert list(by_path) == ["outer/inner", "side", "outer", "stamped"]
    outer, inner, other_s = by_path["outer"], by_path["outer/inner"], by_path["side"]
    # the other thread's span is on its own stack: under no span of this one
    assert rec.root.children == [outer, by_path["stamped"]] and outer.children == [inner]
    assert (outer.request, inner.request, other_s.request, by_path["stamped"].request) == (7, 7, 9, 3)
    assert outer.counts == {"rows": 4} and inner.counts == {"blocks": 2}
    assert w0 <= outer.start_ns <= inner.start_ns <= inner.end_ns <= other_s.start_ns
    assert other_s.end_ns <= outer.end_ns <= w1
    assert (by_path["stamped"].start_ns, by_path["stamped"].end_ns) == (5, 11)
    assert seen == [tm.NOOP] and tm.current() is tm.NOOP
    d = rec.as_dict()
    assert d["name"] == "run" and d["children"][0]["children"][0]["counts"] == {"blocks": 2}


def test_timing_off_builds_nothing_and_never_synchronizes(counted):
    """Neither a prove nor a pipelined stream nor fri_prove inside them builds
    a recorder or a span or reaches a barrier when nobody asked for timing."""
    trace, pi = AIR.generate_trace_and_pi(BATCHES[0])
    proof = prove(AIR, trace, pi, CFG, device="cpu")
    proofs = prove_pipelined(AIR, BATCHES[:2], CFG, device="cpu")
    assert counted == {"spans": 0, "recorders": 0, "syncs": 0}
    assert proof_to_bytes(proofs[0]) == proof_to_bytes(proof)


def test_a_barrier_tree_synchronizes_at_its_phases_only(counted):
    """A TimingTree reaches its barrier at its creation, its finish and both
    ends of each phase (scope); its finer spans (composition's row blocks
    and their parts) reach none."""
    trace, pi = AIR.generate_trace_and_pi(BATCHES[0])
    tt = tm.TimingTree("prove", "cpu")
    proof = prove(AIR, trace, pi, CFG, timing=tt, device="cpu")
    assert verify(AIR, proof, CFG)
    phases = [s for s in tt.spans if s.name not in ("block", "air", "arguments")]
    assert counted["syncs"] == 2 + 2 * len(phases)
    flat = {s.path for s in tt.spans}
    assert {"trace commit", "constraint composition", "constraint composition/block",
            "fri/pow grind"} <= flat
    comp = find(tt, "constraint composition")[0]
    assert comp.counts["blocks"] == len(find(tt, "constraint composition/block")) >= 1
    assert sum(b.counts["rows"] for b in find(tt, "constraint composition/block")) == 128


def test_under_the_profiler_a_prove_records_into_the_device_trace(monkeypatch):
    """While torch.profiler traces and no recorder is set, a prove's spans go
    to DEVICE_TRACE (what the benchmark's span readers read); a recorder set
    by recording(), NOOP included, takes precedence."""
    from torch.profiler import ProfilerActivity, profile

    monkeypatch.setattr(tm, "DEVICE_TRACE", tm.Recorder("device trace"))
    trace, pi = AIR.generate_trace_and_pi(BATCHES[0])
    with profile(activities=[ProfilerActivity.CPU]):
        assert tm._profiling() and tm.current() is tm.DEVICE_TRACE
        prove(AIR, trace, pi, CFG, device="cpu")
        n = len(tm.DEVICE_TRACE.spans)
        with tm.recording(tm.NOOP), tm.span("not recorded"):
            assert tm.current() is tm.NOOP
    assert not tm._profiling() and tm.current() is tm.NOOP
    assert len(tm.DEVICE_TRACE.spans) == n
    assert {"prove", "prove/constraint composition", "prove/fri/pow grind"} <= {
        s.path for s in tm.DEVICE_TRACE.spans}


def test_pipelined_stages_once_a_batch_with_its_index():
    rec = tm.Recorder("stream")
    stamps = []
    with tm.recording(rec):
        proofs = prove_pipelined(AIR, BATCHES, CFG, device="cpu",
                                 on_proof=lambda i, t: stamps.append(time.time_ns()))
    for inputs, got in zip(BATCHES, proofs):
        trace, pi = AIR.generate_trace_and_pi(inputs)
        assert proof_to_bytes(got) == proof_to_bytes(prove(AIR, trace, pi, CFG, device="cpu"))
    for stage in ("wait", "fork", "prove", "trim", "read", "worker tracegen", "copy"):
        got = sorted(s.request for s in find(rec, "pipeline/" + stage))
        assert got == ([0, 1] if stage == "fork" else [0, 1, 2]), stage
    assert len(find(rec, "pipeline")) == 1 + len(BATCHES)  # the stream's, a prefetch's a batch
    assert {s.request for s in find(rec, "pipeline/prove/constraint composition")} == {0, 1, 2}
    # wait + fork + prove + trim cover each period between completed proofs
    for i in (1, 2):
        parts = sum(s.end_ns - s.start_ns for s in rec.spans if s.request == i
                    and s.path in ("pipeline/wait", "pipeline/fork", "pipeline/prove",
                                   "pipeline/trim"))
        assert 0 <= (stamps[i] - stamps[i - 1]) - parts < 20_000_000
    worker = find(rec, "pipeline/worker tracegen")
    assert all(s.start_ns < s.end_ns and s.counts["rows"] == 64 for s in worker)


def _exp_inputs(air_cls):
    """One instance of a G1 or G2 scalar multiplication: x, offset, scalar."""
    gen, mul = ((bn254.G1_GEN, bn254.g1_mul) if air_cls is G1ExpAir
                else (bn254.G2_GEN, bn254.g2_mul))
    return [(mul(gen, 3), mul(gen, 5), 2**200 + 12345)]


@pytest.mark.parametrize("air_cls", [G1ExpAir, G2ExpAir], ids=["g1", "g2"])
def test_exp_tracegen_records_its_parts_in_order(air_cls, counted):
    """An exp AIR's tracegen is a `tracegen` span with its rows and, in
    order, its chain, oracle check, pulses and range check; with no recorder
    it builds no span."""
    air = air_cls(1, range_check="logup", io_binding="rlc")
    inputs = _exp_inputs(air_cls)
    trace, pi = air.generate_trace_and_pi(inputs)
    assert counted["spans"] == 0
    rec = tm.Recorder("run")
    with tm.recording(rec):
        got = air.generate_trace_and_pi(inputs)
    assert np.array_equal(got[0], trace) and np.array_equal(got[1], pi)
    (whole,) = find(rec, "tracegen")
    assert whole.counts == {"rows": 512}
    assert [c.name for c in whole.children] == ["chain", "oracle check", "pulses", "range check"]
    assert all(whole.start_ns <= c.start_ns <= c.end_ns <= whole.end_ns for c in whole.children)


def _composition_blocks(device) -> list:
    air = PairedFibAir()
    trace, pi = air.generate_trace_and_pi(BATCHES[0])
    rec = tm.Recorder("run")
    with tm.recording(rec):
        proof = prove(air, trace, pi, CFG, device=device)
    assert verify(air, proof, CFG)
    blocks = find(rec, "prove/constraint composition/block")
    assert blocks
    for b in blocks:
        assert [c.name for c in b.children] == ["air", "arguments"]
        assert all("field_launches" in c.counts for c in b.children)
    return blocks


def test_a_composition_block_splits_into_the_airs_and_the_arguments_constraints():
    """Each row block's children: `air` (air.eval) then `arguments` (the
    permutation, logUp and aux constraints), each counting its field
    launches (none on the CPU)."""
    for b in _composition_blocks("cpu"):
        assert b.counts["field_launches"] == 0
        assert all(c.counts["field_launches"] == 0 for c in b.children)


@pytest.mark.cuda
def test_card_composition_children_count_the_blocks_field_launches():
    """On the card the children's field launches and the block's division
    by Z_H (one multiply a challenge) are all of the block's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    for b in _composition_blocks(torch.device("cuda", 0)):
        air, args = b.children
        assert air.counts["field_launches"] > 0 and args.counts["field_launches"] > 0
        assert (air.counts["field_launches"] + args.counts["field_launches"]
                + CFG.num_challenges == b.counts["field_launches"])


@pytest.mark.cuda
def test_card_pipeline_times_each_staging_copy():
    """On the card the staging copies run on the side stream: each batch's
    `pipeline/copy` span holds its device time from the event pair, and the
    proofs are those of sequential card proves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    rec = tm.Recorder("stream")
    with tm.recording(rec):
        proofs = prove_pipelined(AIR, BATCHES, CFG, device=dev)
    for inputs, got in zip(BATCHES, proofs):
        trace, pi = AIR.generate_trace_and_pi(inputs)
        assert proof_to_bytes(got) == proof_to_bytes(prove(AIR, trace, pi, CFG, device=dev))
    copies = find(rec, "pipeline/copy")
    assert sorted(s.request for s in copies) == [0, 1, 2]
    assert all(s.counts["device_ms"] > 0 for s in copies)


def test_chip_smoke_busy_share_counts_overlap_once():
    """chip_smoke.profile_prove's busy share: the union of the card's
    intervals clipped to the prove's window, not their sum."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    def event(start, dur, dev=torch.autograd.DeviceType.CUDA):
        return SimpleNamespace(start_ns=lambda: start, duration_ns=lambda: dur, device_type=lambda: dev)

    events = [event(0, 10), event(5, 10), event(20, 10), event(22, 3), event(95, 25),
              event(40, 50, torch.autograd.DeviceType.CPU)]
    prof = SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(
        events=lambda: events)))
    assert chip_smoke._busy_ns(prof, 0, 100) == 15 + 10 + 5
