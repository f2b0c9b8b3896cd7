"""The one general generator: it reads a traffic mix (a data file of
parameters under traffic/) and drives the cell's program through it.

The mix names its loop ("loop"), a module under loops/ found by that name:
loops/closed.py (one caller, a request when the last proof is back) and
loops/stream.py (one saturated prove_pipelined stream). A loop module has

    setup(runner, maker)                          warm the cell's own shape
    window(runner, maker, seconds, trace, rec)    fill rec["requests"], rec["window"]
    profile(runner, maker, rec, n) -> (work, extra)

so a new way to drive the program is a new file there, and a mix or a
cell that uses it new data. The program is the configuration's own
("program" -> programs/<program>.py).

A traced run also times each prove's phases (the program's TimingTree,
whose barriers change the overlap, so only there), and afterwards profiles
the mix's `profile` more requests or batches on the card.

The window's record holds every request's inputs and proof bytes for the
judge, and what the metric readers under metrics/ read."""

from __future__ import annotations

import importlib
import sys
import time
import traceback

clock = time.perf_counter


def _phases(tt) -> dict[str, float]:
    """A TimingTree's scopes as {"a/b": ms}."""
    flat: dict[str, float] = {}

    def walk(node, prefix):
        for c in node.get("children", []):
            flat[prefix + c["name"]] = c["ms"]
            walk(c, prefix + c["name"] + "/")

    d = tt.as_dict()
    flat["prove"] = d["ms"]
    walk(d, "")
    return flat


class Runner:
    """One cell's program, statement maker and traffic, set up once; each
    window() is one measured window on a seed."""

    def __init__(self, config: dict, traffic: dict, maker_cls, program_form, device,
                 fri_overrides: dict | None = None):
        self.config, self.traffic, self.device = config, traffic, device
        self.maker_cls, self.program_form = maker_cls, program_form
        t0 = clock()
        program = importlib.import_module(f"programs.{config['program']}")
        self.program = program.Program(config, device, fri_overrides)
        self.loop = importlib.import_module(f"loops.{traffic['loop']}")
        self.num_io = config["statement"]["num_io"]
        self.warm_s: list[float] = []
        self.setup_log: list[tuple[str, float]] = [("program", clock() - t0)]

    def sync(self):
        if str(self.device).startswith("cuda"):
            import torch

            torch.cuda.synchronize()

    def request(self, maker, stream: int, i: int, timed: bool, spans=None) -> dict:
        """One request of a caller: a fresh statement's tracegen, then its
        prove; a failed request is recorded as failed and the loop goes on."""
        raw = maker.request(stream, i)
        inputs = self.program_form(raw, self.program.bn254)
        rec = {"inputs": raw, "proof": None, "instances": self.num_io}
        t0 = clock()
        w0 = time.time_ns()
        try:
            trace, pi = self.program.tracegen(inputs)
            t1 = clock()
            w1 = time.time_ns()
            tt = self.program.timing_tree() if timed else None
            proof = self.program.prove(trace, pi, timing=tt)
            del trace
            rec["proof"] = self.program.proof_bytes(proof)
            rec["shape"] = self.program.shape(proof)
            if tt is not None:
                rec["phases"] = _phases(tt)
            rec["tracegen_s"] = t1 - t0
        except Exception:
            rec["error"] = traceback.format_exc()
            print(rec["error"], file=sys.stderr)
        rec["start"], rec["end"] = t0, clock()
        if spans is not None:
            w2 = time.time_ns()
            if "tracegen_s" in rec:
                spans += [("tracegen", w0, w1), ("prove", w1, w2)]
            else:
                spans.append(("failed request", w0, w2))
        return rec

    def stream(self, batches: list) -> tuple[list, list[float], float]:
        """One prove_pipelined stream over `batches` (raw inputs): its
        proofs, each proof's completion time and the stream's start."""
        stamps: list[float] = []
        inputs = [self.program_form(b, self.program.bn254) for b in batches]
        self.sync()
        t0 = clock()
        proofs = self.program.prove_stream(inputs, on_proof=lambda i, _t: stamps.append(clock()))
        return proofs, stamps, t0

    def setup(self, seed: int) -> None:
        t0 = clock()
        maker = self.maker_cls(seed, self.num_io)
        self.setup_log.append(("maker", clock() - t0))
        self.loop.setup(self, maker)

    def window(self, seed: int, seconds: float, trace: bool) -> dict:
        import torch

        cuda = str(self.device).startswith("cuda")
        maker = self.maker_cls(seed, self.num_io)
        rec = {"loop": self.traffic["loop"], "seconds": seconds, "num_io": self.num_io,
               "stark": self.program.stark_params()}
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        self.loop.window(self, maker, seconds, trace, rec)
        if cuda:
            self.sync()
            rec["peak_window_bytes"] = torch.cuda.max_memory_allocated()
        if trace and cuda:
            import devtrace

            n = self.traffic["profile"]
            work, extra = self.loop.profile(self, maker, rec, n)
            rec["profile"] = devtrace.profile(work, self.program.launch_counts)
            rec["profile"]["requests"] = n
            rec["profiled_requests"] = extra
        return rec
