"""What decides `correct`: the plain reference, given only the inputs the
benchmark made and the proofs' bytes as a verifier receives them.

Three numbers, each with its limit:
- unproven: requests of the run that never returned a proof;
- wrong_outputs: instances whose public cells in the proof (inputs and
  output) differ from the reference's exact arithmetic;
- rejected: proofs that the frozen verifier rejects under the
  configuration's own STARK config.
Every proof of the run is checked, the window's and the profiled ones, in
worker processes started once the window has closed (a proof takes the
verifier seconds on one core). Each number is an exact count, so each
limit is 0."""

from __future__ import annotations

import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

LIMITS = {"unproven": 0, "wrong_outputs": 0, "rejected": 0}
# a worker is one process on one core: no thread pools of its own
ONE_THREAD = {"OMP_NUM_THREADS": "1", "OPENBLAS_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}


def _one_thread() -> None:
    import torch

    torch.set_num_threads(1)


def _check(args):
    from reference import verify

    return verify.check(*args)


def judge(config: dict, requests: list[dict]) -> dict:
    t0 = time.perf_counter()
    kind, statement, stark = config["reference"], config["statement"], config["stark"]
    tasks = [(kind, statement, stark, r["inputs"], r["proof"]) for r in requests
             if r["proof"] is not None]
    unproven = len(requests) - len(tasks)
    workers = max(1, min(len(tasks), os.cpu_count() or 1))
    results = []
    if tasks:
        saved = {k: os.environ.get(k) for k in ONE_THREAD}
        os.environ.update(ONE_THREAD)  # inherited by the workers, read as they start
        try:
            with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                                     initializer=_one_thread) as pool:
                results = list(pool.map(_check, tasks))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
    wrong = sum(w for w, _ in results)
    rejected = 0
    for k, (_, why) in enumerate(results):
        if why is not None:
            rejected += 1
            print(f"judge: proof {k} rejected: {why}", file=sys.stderr)
    print(f"judge: {len(tasks)} proofs checked in {time.perf_counter() - t0:.1f} s "
          f"over {workers} workers", file=sys.stderr)
    values = {"unproven": unproven, "wrong_outputs": wrong, "rejected": rejected}
    return {k: {"value": v, "limit": LIMITS[k]} for k, v in values.items()}


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
