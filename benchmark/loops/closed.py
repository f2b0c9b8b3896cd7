"""The closed loop: one caller issuing its next request when the last
one's proof is back. A request is a fresh statement made from the seed:
tracegen, then `prove`. Requests are issued until the window's seconds
have passed; the request in flight finishes and counts."""

from __future__ import annotations

from time import perf_counter as clock

WARM = 2  # the first request loads the kernels and the native library; the second runs warm


def setup(runner, maker) -> None:
    for i in range(WARM):
        rec = runner.request(maker, 1, i, timed=False)
        if rec["proof"] is None:
            raise RuntimeError("a warm-up request failed:\n" + rec["error"])
        runner.warm_s.append(rec["end"] - rec["start"])
        runner.setup_log.append((f"warm request {i}", rec["end"] - rec["start"]))


def window(runner, maker, seconds: float, trace: bool, rec: dict) -> None:
    requests = []
    t_end = clock() + seconds
    i = 0
    while True:
        requests.append(runner.request(maker, 0, i, timed=trace))
        i += 1
        if requests[-1]["end"] >= t_end:
            break
    rec["requests"] = requests
    rec["window"] = (requests[0]["start"], requests[-1]["end"])


def profile(runner, maker, rec: dict, n: int):
    """n more requests, each with its host spans."""
    base = len(rec["requests"])
    extra: list = []

    def work(spans):
        for i in range(n):
            extra.append(runner.request(maker, 0, base + i, timed=False, spans=spans))

    return work, extra
