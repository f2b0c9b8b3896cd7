"""The control of `correct`: the program with one guarantee its
configuration states broken, judged by the same reference as every run.
The benchmark's own runs never run it.

    python3 benchmark/control.py --workload <cell> --seeds 11,12,13 --seconds 10 \\
        [--variants pow,queries]

One process sets the cell up once, then for each seed measures a window of
the sound program and one of each control, and judges each as run.py does.
A control proves under a weaker STARK config than the configuration
states, the step a later change might be tempted by:
- pow: half the proof-of-work bits (8 where standard_fast_config states 16);
- queries: half the FRI queries (42 where it states 84).
Each window prints one JSON line {seed, side, checks}; the sound windows
give the lower readings of the numbers `correct` compares, the controls
the upper ones. Without a CUDA card it exits non-zero."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import judge  # noqa: E402
from harness import Cell, load_json  # noqa: E402

CONTROLS = {"pow": "proof_of_work_bits", "queries": "num_query_rounds"}


def weakened(program_cfg, variant: str) -> dict:
    """The FRI field a control halves, at half the configuration's value."""
    field = CONTROLS[variant]
    return {field: getattr(program_cfg.fri, field) // 2}


def readings(cell: Cell, seeds: list[int], seconds: float, variants: list[str], device: str):
    """Yield {seed, side, checks, proofs} for the sound program and each
    control on every seed."""
    from generator import Runner

    maker_cls, program_form = cell.maker()
    sides = {"program": Runner(cell.config, cell.traffic, maker_cls, program_form, device)}
    for v in variants:
        sides[v] = Runner(cell.config, cell.traffic, maker_cls, program_form, device,
                           weakened(sides["program"].program.cfg, v))
    for s in sides.values():
        s.setup(seeds[0])
    for seed in seeds:
        for side, runner in sides.items():
            rec = runner.window(seed, seconds, trace=False)
            checks = judge.judge(cell.config, rec["requests"])
            yield {"seed": seed, "side": side, "checks": checks, "proofs": len(rec["requests"])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--variants", default="pow,queries")
    args = ap.parse_args(argv)
    cell = Cell(load_json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)

    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    for r in readings(cell, [int(s) for s in args.seeds.split(",")], args.seconds,
                      args.variants.split(","), "cuda"):
        r["t"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
