"""The stream: one `prove_pipelined` stream of fresh batches, as a proving
service runs it, pulled as fast as the pipeline takes them. The stream
holds enough batches to cover the window at the pace of the warm-up
stream, so the window ends at its last proof."""

from __future__ import annotations

import math
import statistics
import sys
import time
import traceback
from time import perf_counter as clock

WARM = 3  # a warm stream of three batches: two gaps between proofs set the pace


def setup(runner, maker) -> None:
    t0 = clock()
    proofs, stamps, _ = runner.stream([maker.request(1, i) for i in range(WARM)])
    if len(proofs) != WARM:
        raise RuntimeError("the warm-up stream returned too few proofs")
    # the gaps between proofs: the stream's pace once its fill is over
    runner.warm_s = [b - a for a, b in zip(stamps, stamps[1:])]
    runner.setup_log.append(("warm stream", clock() - t0))
    runner.setup_log += [(f"warm gap {i}", g) for i, g in enumerate(runner.warm_s)]


def window(runner, maker, seconds: float, trace: bool, rec: dict) -> None:
    period = statistics.median(runner.warm_s)
    count = max(2, math.ceil(seconds / period))
    batches = [maker.request(0, i) for i in range(count)]
    requests = [{"inputs": b, "proof": None, "instances": runner.num_io} for b in batches]
    try:
        proofs, stamps, t0 = runner.stream(batches)
    except Exception:
        err = traceback.format_exc()
        print(err, file=sys.stderr)
        proofs, stamps, t0 = [], [], clock()
        for r in requests:
            r["error"] = err
    for r, p in zip(requests, proofs):
        r["proof"] = runner.program.proof_bytes(p)
        r["shape"] = runner.program.shape(p)
    rec["requests"] = requests
    rec["stamps"] = stamps
    rec["window"] = (t0, stamps[-1] if stamps else clock())


def profile(runner, maker, rec: dict, n: int):
    """A stream of n more batches, one host span over it."""
    base = len(rec["requests"])
    extra = [{"inputs": maker.request(0, base + i), "proof": None, "instances": runner.num_io}
             for i in range(n)]

    def work(spans):
        w0 = time.time_ns()
        proofs, _, _ = runner.stream([r["inputs"] for r in extra])
        spans.append(("stream", w0, time.time_ns()))
        for r, p in zip(extra, proofs):
            r["proof"] = runner.program.proof_bytes(p)
            r["shape"] = runner.program.shape(p)

    return work, extra
