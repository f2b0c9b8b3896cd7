"""The readers of composition's split, on synthetic records:
composition_air_ms sums a profiled request's `air` spans under its row
blocks, composition_field_launches the blocks' `field_launches`; each is a
mean over the profiled requests, and a program without the spans or the
counts leaves the metric out."""

import pytest

from test_bench_spans import reader  # puts the benchmark and the repo on sys.path

from starky_bn254_tpu_torch.utils import timing

NAMES = ("composition_air_ms", "composition_field_launches")


def record(loop: str, requests: int) -> dict:
    return {"loop": loop, "profile": {"busy_s": 1.0, "window_s": 2.0, "requests": requests}}


def _prove(rec, ms_blocks, split: bool):
    """One profiled prove: a block a (air ms, arguments ms, field launches)."""
    ms = 1_000_000
    with rec.span("prove"), rec.span("constraint composition"):
        for air_ms, args_ms, launches in ms_blocks:
            with rec.span("block", rows=8):
                if split:
                    rec.add("air", 0, air_ms * ms, field_launches=launches - 10)
                    rec.add("arguments", 0, args_ms * ms, field_launches=8)
                rec.count(field_launches=launches)


@pytest.fixture
def traced(monkeypatch):
    rec = timing.Recorder("device trace")
    monkeypatch.setattr(timing, "DEVICE_TRACE", rec)
    return rec


def test_a_requests_blocks_are_summed_and_requests_averaged(traced):
    _prove(traced, [(30, 5, 1000), (20, 5, 600)], split=True)
    _prove(traced, [(60, 5, 1400)], split=True)
    with traced.span("prove"), traced.span("openings"):
        traced.add("air", 0, 10**9)  # the verifier-style replay outside a block is not read
    got = {n: reader(n)(record("closed", 2)) for n in NAMES}
    assert got == {"composition_air_ms": 55.0, "composition_field_launches": 1500.0}
    assert all(reader(n)(record("stream", 2)) is None for n in NAMES)


def test_blocks_without_the_split_leave_only_the_air_time_out(traced):
    _prove(traced, [(30, 5, 1000)], split=False)
    assert reader("composition_air_ms")(record("closed", 1)) is None
    assert reader("composition_field_launches")(record("closed", 1)) == 1000.0


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_leaves_the_metric_out(traced, monkeypatch, name):
    assert reader(name)({"loop": "closed"}) is None
    assert reader(name)(record("closed", 1)) is None
    monkeypatch.delattr(timing, "DEVICE_TRACE")  # a program before the recorder
    assert reader(name)(record("closed", 1)) is None
