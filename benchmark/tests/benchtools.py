"""What the benchmark's own CPU tests share (they are not collected by the
repo's tier-1 run):

    python -m pytest benchmark/tests -q -p no:cacheprovider

Importing this module puts the benchmark and the repo on sys.path. Tests
that need a CUDA card are marked `cuda` and skip without one."""

import json
import os
import shutil
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

# a statement the CPU proves in seconds: upstream's G1 AIR at 2 instances
TINY_CONFIG = {
    "name": "g1-exp-2",
    "source": "test size",
    "program": "air",
    "statement": {"air": "G1ExpAir", "module": "g1_exp", "num_io": 2,
                  "range_check": "logup", "io_binding": "rlc"},
    "stark": {"preset": "test_config"},
    "inputs": "g1_exp",
    "reference": "g1_exp",
    "reduced": [],
}


def tiny_traffic(loop: str) -> dict:
    return {"name": "tiny-" + loop, "loop": loop, "profile": 1}


@pytest.fixture
def tiny_bench(tmp_path):
    return make_tiny_bench(tmp_path)


def make_tiny_bench(tmp_path):
    """A checkout's copy of the benchmark with a tiny configuration and a
    cell of each loop added as new files and entries only."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    (root / "benchmark" / "configs" / "g1-exp-2.json").write_text(json.dumps(TINY_CONFIG))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "g1-exp-2", "source": "test size",
                             "file": "benchmark/configs/g1-exp-2.json", "reduced": [], "why": "test"})
    for loop in ("closed", "stream"):
        (root / "benchmark" / "traffic" / f"tiny-{loop}.json").write_text(json.dumps(tiny_traffic(loop)))
        bench["workloads"].append({"name": f"g1-exp-2.{loop}", "config": "g1-exp-2",
                                   "traffic": f"tiny-{loop}", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [f"g1-exp-2.{'closed' if 'g1-exp-128.single' in m['workloads'] else 'stream'}"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_cpu(root, workload: str, seed: int = 7, seconds: float = 0.1, trace: int = 0,
            patch: str = "", timeout: int = 900) -> dict:
    """One run of `workload` of the checkout `root` on the CPU, in a fresh
    interpreter (the chip check skipped, the rest as run.py does it), with
    `patch` run first (a fault planted under the timed path); the result
    line's object, and the stderr lines under "stderr"."""
    import subprocess
    import textwrap

    bench = os.path.join(str(root), "benchmark")
    code = textwrap.dedent(f"""
        import sys, time
        sys.path[:0] = [{bench!r}, {str(root)!r}, {ROOT!r}]
        import torch
        torch.set_num_threads(2)
        import harness, run
        """) + textwrap.dedent(patch) + textwrap.dedent(f"""
        cell = harness.Cell(harness.load_json({str(root)!r} + "/BENCHMARK.json"), {workload!r},
                            here={bench!r})
        run.report(run.run_cell(cell, {seed}, {seconds}, bool({trace}), "cpu", time.perf_counter()))
        """)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=timeout,
                       cwd=str(root))
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    out["stderr"] = p.stderr.strip().splitlines()
    return out
