"""The device's side of a traced run: a torch.profiler trace of the card
over a stretch of work, reduced to busy time (the union of device
activity intervals, so overlapping streams count once), time by device
operation, the idle gaps by what the host was doing, and the hand
kernels' launches in the trace against the launches the program's
wrappers counted (the profiler drops events at about a million launches).
And the card's clocks and power from nvidia-smi."""

from __future__ import annotations

import re
import subprocess
import sys
import time

# the hand kernels' names in the device trace, by the wrapper counting them
HAND_KERNELS = {"ntt": ("ntt_pass_kernel",), "keccak": ("keccak_sponge_kernel",),
                "poseidon": ("poseidon_sponge_kernel", "poseidon_coop_kernel",
                             "poseidon_grind_kernel")}
TOP = 10


def kernel_name(raw: str) -> str:
    name = raw.split("(")[0].split("<")[0].replace("void ", "").strip()
    return re.sub(r"\s+", " ", name) or raw


def union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def summarize(events: list[tuple[str, int, int]], spans: list[tuple[str, int, int]],
              w0: int, w1: int) -> dict:
    """events: (name, start_ns, end_ns) of device activity; spans: (label,
    start_ns, end_ns) of the host's work, on the same clock; [w0, w1]: the
    traced window. Busy time is the union of the events clipped to the
    window; each idle gap is named by the host span it overlaps most."""
    clipped = [(max(a, w0), min(b, w1)) for _, a, b in events if b > w0 and a < w1]
    busy = union([(a, b) for a, b in clipped if b > a])
    busy_ns = sum(b - a for a, b in busy)
    by_name: dict[str, list] = {}
    for name, a, b in events:
        entry = by_name.setdefault(name, [0, 0.0])
        entry[0] += 1
        entry[1] += (b - a) / 1e9
    gaps, cur = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)

    def host_during(a: int, b: int) -> str:
        """The host span that overlaps [a, b) most ("harness": none)."""
        best, label = 0, "harness"
        for lb, s0, s1 in spans:
            overlap = min(b, s1) - max(a, s0)
            if overlap > best:
                best, label = overlap, lb
        return label

    named_gaps = sorted(((host_during(a, b), (b - a) / 1e9) for a, b in gaps), key=lambda g: -g[1])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return dict(busy_s=busy_ns / 1e9, window_s=(w1 - w0) / 1e9,
                kernels={k: {"launches": v[0], "seconds": v[1]} for k, v in by_name.items()},
                device_ops=[[k, v[1]] for k, v in ops[:TOP]],
                idle_gaps=[[label, s] for label, s in named_gaps[:TOP]])


def hand_launches(kernels: dict) -> dict[str, int]:
    return {k: sum(kernels.get(n, {}).get("launches", 0) for n in names)
            for k, names in HAND_KERNELS.items()}


def profile(work, launch_counts) -> dict:
    """Run work(spans) under torch.profiler on the card; work appends
    (label, start_ns, end_ns) host spans on time.time_ns(), the profiler's
    clock. Returns summarize()'s reduction with the hand kernels' launches
    in the trace (`traced`) beside the wrappers' counts (`counted`)."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    spans: list[tuple[str, int, int]] = []
    before = launch_counts()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        w0 = time.time_ns()
        work(spans)
        torch.cuda.synchronize()
        w1 = time.time_ns()
    after = launch_counts()
    events = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            events.append((kernel_name(e.name()), e.start_ns(), e.start_ns() + e.duration_ns()))
    out = summarize(events, spans, w0, w1)
    out["traced"] = hand_launches(out["kernels"])
    out["counted"] = {k: after[k] - before[k] for k in after}
    out["dropped"] = {k: out["counted"][k] - out["traced"].get(k, 0) for k in out["counted"]
                      if out["counted"][k] > out["traced"].get(k, 0)}
    for k, n in out["dropped"].items():
        print(f"devtrace: the trace holds {out['traced'].get(k, 0)} {k} launches, the wrapper "
              f"counted {out['counted'][k]}: the profiler dropped {n}; {k}'s roofline is left out",
              file=sys.stderr)
    return out


SMI_FIELDS = "name,clocks.sm,clocks.max.sm,power.draw,power.limit,temperature.gpu"


def smi() -> str:
    """One nvidia-smi reading of every card (or why there is none)."""
    try:
        r = subprocess.run(["nvidia-smi", f"--query-gpu={SMI_FIELDS}", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return r.stdout.strip() or r.stderr.strip()
