"""The readers of the program's own spans, on synthetic records: each reads
the port's DEVICE_TRACE recorder of the profiled work in its own loop's
record, and a program without that recorder leaves the metric out."""

import importlib.util
import os

import pytest

from benchtools import BENCH

from starky_bn254_tpu_torch.utils import timing

SINGLE = ("tracegen_chain_ms", "tracegen_check_ms", "tracegen_rangecheck_ms")
SERVICE = ("prefetch_wait_ms.service", "stream_prove_ms.service", "worker_tracegen_ms.service")


def reader(name: str):
    path = os.path.join(BENCH, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def record(loop: str) -> dict:
    return {"loop": loop, "profile": {"busy_s": 1.0, "window_s": 2.0}}


@pytest.fixture
def traced(monkeypatch):
    """A DEVICE_TRACE of its own, filled as two profiled requests (closed
    loop) or a profiled stream of three batches would fill it."""
    rec = timing.Recorder("device trace")
    monkeypatch.setattr(timing, "DEVICE_TRACE", rec)
    ms = 1_000_000
    for r, base in enumerate((0, 1000 * ms)):
        with rec.span("tracegen"):
            rec.add("chain", base, base + (10 + r) * ms)
            rec.add("oracle check", base, base + (20 + r) * ms)
            rec.add("range check", base, base + (30 + r) * ms)
    with rec.span("pipeline"):
        for b in range(3):
            with timing.request(b):
                rec.add("wait", 0, (100 if b == 0 else 4 + b) * ms)
                rec.add("prove", 0, (1000 + 10 * b) * ms)
                rec.add("trim", 0, ms)
    for b in range(3):
        with rec.span("pipeline", request=b):
            rec.add("worker tracegen", 0, (500 + b) * ms)
    return rec


def test_tracegen_parts_read_the_profiled_requests_means(traced):
    got = {name: reader(name)(record("closed")) for name in SINGLE}
    assert got == {"tracegen_chain_ms": 10.5, "tracegen_check_ms": 20.5,
                   "tracegen_rangecheck_ms": 30.5}
    assert all(reader(name)(record("stream")) is None for name in SINGLE)


def test_stream_stages_read_per_batch_means_without_the_fill_wait(traced):
    got = {name: reader(name)(record("stream")) for name in SERVICE}
    assert got == {"prefetch_wait_ms.service": 5.5, "stream_prove_ms.service": 1010.0,
                   "worker_tracegen_ms.service": 501.0}
    assert all(reader(name)(record("closed")) is None for name in SERVICE)


@pytest.mark.parametrize("name", SINGLE + SERVICE)
def test_nothing_to_read_leaves_the_metric_out(traced, monkeypatch, name):
    loop = "closed" if name in SINGLE else "stream"
    unprofiled = {"loop": loop}
    assert reader(name)(unprofiled) is None
    traced.clear()
    assert reader(name)(record(loop)) is None
    monkeypatch.delattr(timing, "DEVICE_TRACE")  # a program before the recorder
    assert reader(name)(record(loop)) is None
