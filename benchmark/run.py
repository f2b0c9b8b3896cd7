"""One run of one benchmark cell on the card(s) of this machine:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Set-up (imports, the kernels' and the native
library's build or load, the seeded statement maker, warm-up of the cell's
own statement shape) is timed from the start of this file. The port keeps
its nvcc and g++ builds in starky_bn254_tpu_torch/_build/, inside the
checkout, so only a checkout's first run builds. Then the window
runs for --seconds; with --trace 1 the prove phases are timed and more
requests are profiled on the card after it. Last, with the program's state
freed, the plain reference judges every proof (judge.py).

The last line of standard output is the result, one JSON object; the last
lines of standard error are the numbers `correct` was decided by, each
beside its limit. Without a CUDA card, with fewer cards than the cell asks
for, or with JAX or the JAX package loaded once the window has closed, the
run prints no result and exits non-zero."""

import time

T0 = time.perf_counter()  # set-up starts here

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import devtrace  # noqa: E402
import judge  # noqa: E402
from harness import Cell, forbidden_modules, load_json  # noqa: E402


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t0: float) -> dict:
    """Set up, measure one window, judge it; the result line's object."""
    import torch

    from generator import Runner

    cuda = device.startswith("cuda")
    maker_cls, program_form = cell.maker()
    runner = Runner(cell.config, cell.traffic, maker_cls, program_form, device)
    runner.setup(seed)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in runner.setup_log)
          + f"; all {setup_s:.3f} s", file=sys.stderr)
    if cuda:
        print(f"nvidia-smi before the window: {devtrace.smi()}", file=sys.stderr)
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    record = runner.window(seed, seconds, trace)
    if cuda:
        print(f"nvidia-smi after the window: {devtrace.smi()}", file=sys.stderr)
    record["setup_s"] = setup_s
    print(f"window: {spans(record)}", file=sys.stderr)
    metrics = cell.metrics(record, trace)
    requests = record["requests"] + record.get("profiled_requests", [])
    peak = max(setup_peak, record.get("peak_window_bytes", 0))
    del runner
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = judge.judge(cell.config, requests)
    result = {
        "correct": judge.passed(checks),
        "attempted": len(requests),
        "failed": sum(r["proof"] is None for r in requests),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips, "memory_peak_bytes": peak},
    }
    if "profile" in record:
        prof = record["profile"]
        result["device"]["busy_s"] = prof["busy_s"]
        result["device"]["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    result["checks"] = checks
    return result


def spans(record: dict) -> str:
    """Each request's seconds (closed loop) or each gap between proofs
    (stream) in the window, for the spread's look."""
    if "stamps" in record:
        t = [record["window"][0]] + record["stamps"]
        return "proof gaps s " + " ".join(f"{b - a:.3f}" for a, b in zip(t, t[1:]))
    return "request s " + " ".join(f"{r['end'] - r['start']:.3f}" for r in record["requests"])


def report(result: dict) -> None:
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(load_json(os.path.join(ROOT, "BENCHMARK.json")), args.workload)

    import torch

    if not torch.cuda.is_available():
        print("run: no CUDA card (torch.cuda.is_available() is False); no result", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"run: {cell.name} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}; no result", file=sys.stderr)
        return 2
    return guarded_report(run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0))


def guarded_report(result: dict, modules=None) -> int:
    """Report the result unless JAX or the JAX package is loaded in this
    process once the window has closed: then name it and report nothing."""
    bad = forbidden_modules(sys.modules if modules is None else modules)
    if bad:
        print(f"run: JAX or the JAX package was loaded: {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
